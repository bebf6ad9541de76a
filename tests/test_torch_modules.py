"""The port's ops and blocks against their JAX modules on the CPU.

Each block's weights come from the golden fill (tests/goldens.py) over the
port module's own reference-named state dict; the JAX package's converter
(`_TreeBuilder`, pure numpy) maps them onto the Flax tree, so both sides run
the same numbers. Inputs are numpy from a seed, NHWC on the JAX side and
channels_last NCHW on the port's. Tolerance: atol 1e-4 for blocks of a few
float32 convolutions summed in another order (values are O(1)); 1e-6 for
the pure pooling ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import fill_state_dict
from octave_tpu.models import resnest as jres
from octave_tpu.ops import common as jcommon
from octave_tpu.ops.norm import fold_batch_stats as jax_fold, folded_inference as jax_folded
from octave_tpu.utils.torch_convert import _TreeBuilder
from octave_tpu_torch.models import resnest as tres
from octave_tpu_torch.ops import common as tcommon
from octave_tpu_torch.ops.norm import fold_batch_stats, folded_inference
from octave_tpu_torch.utils.convert import load_reference_state_dict

ATOL = 1e-4


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _filled(module: torch.nn.Module):
    """Fill `module` from its own state-dict manifest; return the numpy sd."""
    manifest = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = fill_state_dict(manifest)
    load_reference_state_dict(module, sd)
    return sd


def _jax_vars(sd, build):
    b = _TreeBuilder(sd)
    build(b)
    return b.finish()


def _run_both(tmod, jmod, sd, build, x, folded, **jkw):
    variables = _jax_vars(sd, build)
    if folded:
        load_reference_state_dict(tmod, fold_batch_stats(
            {k: torch.from_numpy(v) for k, v in sd.items()}))
        folded_inference(tmod)
        variables = jax_fold(variables)
        with jax_folded():
            want = jmod.apply(variables, jnp.asarray(x), False, **jkw)
    else:
        want = jmod.apply(variables, jnp.asarray(x), False, **jkw)
    tmod.eval()
    return tmod, want


@pytest.mark.parametrize("folded", [False, True], ids=["raw", "folded"])
def test_splat_matches_jax(rng, folded):
    tmod = tres.SplAtConv2d(32, 32, groups=2, bias=True)
    sd = _filled(tmod)
    jmod = jres.SplAtConv2d(in_channels=32, channels=32, kernel_size=3, padding=1,
                            groups=2, use_bias=True, radix=2)
    x = rng.standard_normal((2, 9, 7, 32)).astype(np.float32)
    tmod, want = _run_both(tmod, jmod, sd, lambda b: b.splat("", ()), x, folded)
    with torch.no_grad():
        got = tmod(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("folded", [False, True], ids=["raw", "folded"])
def test_bottleneck_matches_jax(rng, folded):
    # strided first block of a stage: avd pooling and the ceil_mode avg_down
    # shortcut, on an odd 9x9 map
    tmod = tres.Bottleneck(64, 32, 2, has_downsample=True)
    sd = _filled(tmod)
    jmod = jres.Bottleneck(inplanes=64, planes=32, strides=2, has_downsample=True, radix=2,
                           cardinality=1, bottleneck_width=64, avd=True, is_first=True,
                           avg_down=True)
    x = rng.standard_normal((2, 9, 9, 64)).astype(np.float32)
    tmod, want = _run_both(tmod, jmod, sd, lambda b: b.bottleneck("", ()), x, folded)
    with torch.no_grad():
        got = tmod(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 5, 5, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("folded", [False, True], ids=["raw", "folded"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_decoder_matches_jax(rng, folded, fused):
    tmod = tres.ResNestDecoder(64, 32)
    sd = _filled(tmod)
    jmod = jres.ResNestDecoder(64, 32)
    x = rng.standard_normal((2, 10, 12, 64)).astype(np.float32)
    gate = torch.nn.Conv2d(32, 2, 1)
    gw = (rng.standard_normal((32, 2)) * 0.1).astype(np.float32)
    gb = (rng.standard_normal((2,)) * 0.1).astype(np.float32)
    with torch.no_grad():
        gate.weight.copy_(torch.from_numpy(gw.T.reshape(2, 32, 1, 1)))
        gate.bias.copy_(torch.from_numpy(gb))
    jkw = {"aag_kb": (jnp.asarray(gw), jnp.asarray(gb))} if fused else {}
    tmod, want = _run_both(tmod, jmod, sd, lambda b: b.decoder("", ()), x, folded, **jkw)
    with torch.no_grad():
        got = tmod(_nchw(x), gate=gate if fused else None)
    if fused:
        (g_out, g_yhat), (w_out, w_yhat) = got, want
        np.testing.assert_allclose(g_yhat.numpy(), np.asarray(w_yhat), atol=ATOL)
        got, want = g_out, w_out
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL)


def test_resnest_features_match_jax(rng):
    """Stem, maxpool and the four stages of resnest50 at 64²."""
    from octave_tpu.utils.torch_convert import convert_resnest50

    tmod = tres.resnest50()
    sd = _filled(tmod)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)

    def features(m, x):
        return m.layer4(m.layer3(m.layer2(m.layer1(m.maxpool(m.stem(x, False)), False),
                                          False), False), False)

    want = jres.resnest50().apply(convert_resnest50(sd, with_fc=False), jnp.asarray(x),
                                  method=features)
    with torch.no_grad():
        got = tmod.eval()(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 2, 2, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("hw", [(9, 9), (10, 7)])
def test_pools_match_jax(rng, hw):
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    t = _nchw(x)
    cases = [
        (tcommon.max_pool2d(t, 3, 2, 1), jcommon.max_pool2d(jnp.asarray(x), 3, 2, 1)),
        (tcommon.avg_pool2d(t, 3, 2, 1), jcommon.avg_pool2d(jnp.asarray(x), 3, 2, 1)),
        (tcommon.avg_pool2d(t, 2, 2, 0, count_include_pad=False, ceil_mode=True),
         jcommon.avg_pool2d(jnp.asarray(x), 2, 2, 0, count_include_pad=False,
                            ceil_mode=True)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=1e-6)


def test_conv_transpose_matches_jax(rng):
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    w = rng.standard_normal((8, 6, 2, 2)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    got = tcommon.conv_transpose_2x2(_nchw(x), torch.from_numpy(w), torch.from_numpy(b))
    want = jcommon.conv_transpose_2x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_fold_batch_stats_matches_jax():
    tmod = tres.ResNestDecoder(16, 8)
    sd = _filled(tmod)
    want = jax_fold(_jax_vars(sd, lambda b: b.decoder("", ())))["params"]
    got = fold_batch_stats({k: torch.from_numpy(v) for k, v in sd.items()})
    for tkey, path in (("conv.1", ("bn1",)), ("downsample.1", ("downsample_bn",)),
                       ("conv.3.bn0", ("splat", "bn0"))):
        node = want
        for p in path:
            node = node[p]
        np.testing.assert_allclose(got[tkey + ".weight"].numpy(), np.asarray(node["scale"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got[tkey + ".bias"].numpy(), np.asarray(node["bias"]),
                                   rtol=1e-6, atol=1e-7)
