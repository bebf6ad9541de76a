"""The port's reference-API surface against the JAX package's, on the CPU.

The reference's loss classes and LS-GAN classes, the padding helpers,
CE-Net's BasicBlock and BuildResNet with their weight map, ResNeStConfig,
the names `models` and `losses` re-export and the package's lazy entry
points. Loss values agree to 1e-6 relative, as tests/test_torch_losses.py;
the ResNet forwards to 1e-4 (float32 convs summed in another order, values
O(1)). Last, a port state dict written by the port's `export_weights_npz`
reads back through the JAX package's `load_weights_npz` and
`convert_resnest_unet` and maps back through `from_jax_variables` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octave_tpu
import octave_tpu.losses as jlosses
import octave_tpu.models as jmodels
import octave_tpu_torch
import octave_tpu_torch.losses as tlosses
import octave_tpu_torch.models as tmodels
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models import resnest as jres
from octave_tpu.utils import padding as jpad
from octave_tpu_torch.models import resnest as tres
from octave_tpu_torch.utils import padding as tpad
from octave_tpu_torch.utils.convert import from_jax_build_resnet

RTOL = 1e-6
ATOL = 1e-4


def _probs(rng, shape):
    a = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    return a / a.sum(-1, keepdims=True)


def _loss_cases(rng):
    probs = _probs(rng, (2, 8, 8, 2))
    ys = (np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 8, 8))]
          * (rng.uniform(size=(2, 8, 8, 1)) > 0.5)).astype(np.float32)
    atts = [_probs(rng, (2, s, s, 2)) for s in (8, 4, 2)]
    logits = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    gan = [rng.standard_normal((4, 1)).astype(np.float32) for _ in range(2)]
    weight = np.array([0.3, 1.7], np.float32)
    return {
        "WeightedPartialCE": (lambda m: m.WeightedPartialCE(2, manual=True), (probs, ys), {}),
        "WeightedPartialCE_ce": (lambda m: m.WeightedPartialCE(2), (logits, ys),
                                 {"ignore_bg": True}),
        "WeightedPartialCE_full": (lambda m: m.WeightedPartialCE(2, manual=True), (probs, ys),
                                   {"reduction": "sum", "full": True}),
        "DiceLoss": (lambda m: m.DiceLoss(), (probs, ys), {}),
        "ImageMseLoss": (lambda m: m.ImageMseLoss(), (probs, ys), {}),
        "InterlayerDivergence": (lambda m: m.InterlayerDivergence(), (atts,), {}),
        "InterlayerDivergence_jsd": (lambda m: m.InterlayerDivergence(divergence="JSD"),
                                     (atts, [0.5, 2.0]), {}),
        "CELoss": (lambda m: m.CELoss(weight), (logits, ys), {}),
        "LSDiscriminatorialLoss": (lambda m: m.LSDiscriminatorialLoss(), tuple(gan), {}),
        "LSGeneratorLoss": (lambda m: m.LSGeneratorLoss(), (gan[0],), {}),
    }


def _to(pkg, arg):
    if isinstance(arg, list) and arg and isinstance(arg[0], np.ndarray):
        return [_to(pkg, a) for a in arg]
    if isinstance(arg, np.ndarray):
        return torch.from_numpy(arg) if pkg is tlosses else jnp.asarray(arg)
    return arg


@pytest.mark.parametrize("name", sorted(_loss_cases(np.random.default_rng(0))))
def test_loss_classes_match_jax(name):
    make, args, kw = _loss_cases(np.random.default_rng(1))[name]
    want = make(jlosses)(*[_to(jlosses, a) for a in args], **kw)
    got = make(tlosses)(*[_to(tlosses, a) for a in args], **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_interlayer_divergence_modes_raise_as_jax():
    for pkg in (jlosses, tlosses):
        with pytest.raises(NotImplementedError):
            pkg.InterlayerDivergence(mode="sum")
    with pytest.raises(ValueError, match="max"):
        tlosses.InterlayerDivergence(mode="max")


def test_padding_helpers_match_jax():
    for n in (7, 16, 33):
        for k in (1, 2, 3, 5, 7):
            for s in (1, 2, 3):
                assert tpad.get_same_padding_conv(n, k, s) == jpad.get_same_padding_conv(n, k, s)
                assert (tpad.get_same_padding_transpose(n, k, s)
                        == jpad.get_same_padding_transpose(n, k, s))
    draws = [tpad.rand_uniform(torch.Generator().manual_seed(3)) for _ in range(2)]
    assert draws[0].shape == () and draws[0].dtype == torch.float32
    assert torch.equal(draws[0], draws[1]) and 0.0 <= float(draws[0]) < 1.0
    assert float(tpad.rand_uniform(torch.Generator().manual_seed(4))) != float(draws[0])


def _jitter(variables, rng):
    """The JAX init with every leaf moved by noise, BN stats kept positive:
    a map that swapped two leaves of one shape would show."""
    def move(path, v):
        v = np.asarray(v)
        if path[-1].key == "kernel":  # kept at the init's scale: activations stay O(1)
            return (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        noise = rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var" else (
            rng.standard_normal(v.shape) * 0.1)
        return (v + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


@pytest.fixture(scope="module")
def resnets():
    """BuildResNet((1, 2, 1, 1)) of both packages, the JAX init's weights
    (jittered) carried over by `from_jax_build_resnet`."""
    jmod, tmod = jres.BuildResNet((1, 2, 1, 1)), tres.BuildResNet((1, 2, 1, 1))
    rng = np.random.default_rng(5)
    variables = _jitter(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), False), rng)
    missing, unexpected = tmod.load_state_dict(from_jax_build_resnet(variables), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return jmod, tmod.eval(), variables


@pytest.mark.parametrize("case", ["resnet", "block_stride2", "block_identity"])
def test_resnet_of_basic_blocks_matches_jax(resnets, rng, case):
    """The whole ResNet at 32², and two of its BasicBlocks on their own:
    layer2's first (stride 2, 1x1 shortcut) and second (identity)."""
    jmod, tmod, variables = resnets
    if case != "resnet":
        name = {"block_stride2": "layer2_0", "block_identity": "layer2_1"}[case]
        jmod = jres.BasicBlock(inplanes=64 if name == "layer2_0" else 128, planes=128,
                               strides=2 if name == "layer2_0" else 1,
                               has_downsample=name == "layer2_0")
        tmod = tmod.layer2[int(name[-1])]
        variables = {c: tree[name] for c, tree in variables.items()}
    x = rng.standard_normal((1, 32, 32, 3) if case == "resnet" else
                            (2, 9, 9, 64 if case == "block_stride2" else 128)).astype(np.float32)
    want = jmod.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_resnest_config_matches_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(tres.ResNeStConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jres.ResNeStConfig)])
    small = tres.ResNeSt(tres.ResNeStConfig(layers=(1, 1, 1, 1), stem_width=16))
    assert small.conv1[0].out_channels == 16 and len(small.layer3) == 1
    with pytest.raises(NotImplementedError, match="radix"):
        tres.ResNeSt(tres.ResNeStConfig(radix=4))


def test_reexports_and_lazy_names_match_jax():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(mod))}

    assert public(tmodels) == public(jmodels)
    assert public(tlosses) == public(jlosses)
    assert set(octave_tpu_torch._LAZY) == set(octave_tpu._LAZY)
    for name in octave_tpu._LAZY:
        assert getattr(octave_tpu_torch, name).__name__ == name
    with pytest.raises(AttributeError, match="nope"):
        octave_tpu_torch.nope


def test_npz_export_round_trips_through_the_jax_converter(tmp_path):
    """port state dict -> port `export_weights_npz` -> JAX `load_weights_npz`
    -> JAX `convert_resnest_unet` -> port `from_jax_variables`: the
    bf16-rounded state dict, bit for bit, every key."""
    from octave_tpu.utils.checkpoint import load_weights_npz
    from octave_tpu.utils.torch_convert import convert_resnest_unet
    from octave_tpu_torch.utils.checkpoint import export_weights_npz
    from octave_tpu_torch.utils.convert import from_jax_variables

    torch.manual_seed(0)
    sd = {k: v for k, v in tmodels.ResnestUNet(2).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    path = str(tmp_path / "unet.npz")
    export_weights_npz(path, sd)
    back = from_jax_variables(convert_resnest_unet(load_weights_npz(path)))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.bfloat16().float().numpy(), err_msg=k)
