"""The port's segmentor family against the reference goldens and the JAX
package, on the CPU.

Goldens: `ph112` and `phg112` hold the original reference's float32 outputs
of the two dual-decoder U-Nets on the deterministic fill (tests/goldens.py);
the fill loads straight into the port (1e-3, as tests/test_golden.py).

JAX parity at 64²: one reference-named fill per model goes through the JAX
package's converter (`convert_resnest_unet`) into the JAX module and, back
through the port's `from_jax_variables`, into the port's module; both run
the same input in float32 (1e-4 on every output). Covered: ResnestUNet with
encoder gating and the classification heads (all four modes), the plain
dual decoder, and the gated one at gating levels 4 and 3, unfused and fused.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import fill_state_dict, input_array, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models import segmentor as jseg
from octave_tpu.utils.torch_convert import convert_discriminator, convert_resnest_unet
from octave_tpu_torch.models.segmentor import (
    ResnestUNet,
    ResnestUnetParallelHead,
    ResnestUnetParallelHeadAttentionGate,
    build_segmentor,
)
from octave_tpu_torch.utils.convert import (
    from_jax_critics,
    from_jax_variables,
    load_reference_state_dict,
)

HW = 64
TOL = 1e-4  # float32, port against JAX on the same weights


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _nhwc_input(seed, hw=HW):
    return np.ascontiguousarray(input_array(seed, (1, 3, hw, hw)).transpose(0, 2, 3, 1))


def _port_eval(model, x):
    model.eval().to(memory_format=torch.channels_last)
    with torch.no_grad():
        return model(torch.from_numpy(x))


# --- goldens ----------------------------------------------------------------

def test_golden_parallel_head112():
    manifest, meta, out = load_fixture("ph112")
    model = load_reference_state_dict(ResnestUnetParallelHead(2), fill_state_dict(manifest))
    x = _nhwc_input(meta["seed"], meta["hw"])
    agg = _port_eval(model, x)
    with torch.no_grad():
        pred = model.predict(torch.from_numpy(x))
    for got, label in ((agg, "agg"), (pred, "pred")):
        got = got.permute(0, 1, 4, 2, 3).numpy()
        assert got.shape == out[label].shape, label
        assert _max_err(got, out[label]) < 1e-3, label


@pytest.mark.parametrize("fused", [False, True], ids=["aag", "fused"])
def test_golden_parallel_head_gate112(fused):
    """gating_level 3: four main gates and two `_c` gates; aag_4 is in the
    file but never runs."""
    manifest, meta, out = load_fixture("phg112")
    model = ResnestUnetParallelHeadAttentionGate(2, meta["gating_level"],
                                                 use_fused_decoder=fused)
    assert model.idle_prefixes() == ("aag_4.",)
    load_reference_state_dict(model, fill_state_dict(manifest))
    (atts, atts_c), agg = _port_eval(model, _nhwc_input(meta["seed"], meta["hw"]))
    assert len(atts) == meta["n_atts"] and len(atts_c) == meta["n_atts_c"]
    for prefix, pyramid in (("att", atts), ("attc", atts_c)):
        for i, a in enumerate(pyramid):
            assert _max_err(a.permute(0, 3, 1, 2), out[f"{prefix}{i}"]) < 1e-3, f"{prefix}{i}"
    assert _max_err(agg.permute(0, 1, 4, 2, 3), out["agg"]) < 1e-3


def test_heads_load_only_when_built():
    """unet112's file carries the classification heads: a model built with
    heads takes them, the default model drops them and keeps the state dict
    it always had."""
    manifest, _, _ = load_fixture("unet112")
    sd = fill_state_dict(manifest)
    plain, headed = ResnestUNet(2), ResnestUNet(2, heads=True)
    load_reference_state_dict(plain, sd)
    load_reference_state_dict(headed, sd)
    heads = {k for k in headed.state_dict() if k.startswith("linear_head_")}
    assert heads and not any(k.startswith("linear_head_") for k in plain.state_dict())
    assert set(headed.state_dict()) - set(plain.state_dict()) == heads
    assert {k for k in manifest if k.startswith("linear_head_")} == heads
    for k in heads:
        assert np.array_equal(headed.state_dict()[k].numpy(), sd[k]), k
    with pytest.raises(ValueError, match="missing"):
        load_reference_state_dict(ResnestUNet(2, heads=True),
                                  {k: v for k, v in sd.items() if not k.startswith("linear_")})


# --- JAX parity -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _filled(arch, gating_level=4, encoder_gating=False, heads=False):
    """(reference-named fill, JAX variables from it) for a port module's keys."""
    model = build_segmentor(arch, 2, gating_level, encoder_gating=encoder_gating,
                            **({"heads": True} if heads else {}))
    manifest = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = fill_state_dict(manifest)
    variables = convert_resnest_unet(sd, gating_level, encoder_gating=encoder_gating,
                                     parallel_head=arch == "parallel_head",
                                     parallel_gates=arch == "parallel_head_gate")
    return sd, variables


def _jax_apply(module, variables, x, **kw):
    fn = jax.jit(functools.partial(module.apply, **kw))
    return jax.tree.map(np.asarray, fn(variables, jnp.asarray(x)))


def _port_from_jax(model, variables):
    return load_reference_state_dict(model, from_jax_variables(variables))


def test_encoder_gating_and_heads_match_jax():
    """The five encoder gates (16-channel softmaxes), the pyramid, agg map
    and x_4, then classification_predict in all four modes."""
    _, variables = _filled("unet", encoder_gating=True, heads=True)
    x = _nhwc_input(3)
    jm = jseg.ResnestUNet(num_classes=2, encoder_gating=True)
    port = _port_from_jax(ResnestUNet(2, encoder_gating=True, heads=True), variables)
    gates, atts, agg, x4 = _port_eval(port, x)
    j_gates, j_atts, j_agg, j_x4 = _jax_apply(jm, variables, x, train=False)
    assert len(gates) == len(j_gates) == 5
    for i, (g, jg) in enumerate(zip(gates, j_gates)):
        assert g.shape == jg.shape and g.shape[-1] == 16, i
        assert _max_err(g, jg) < TOL, f"gate {i}"
    for a, ja in zip(atts, j_atts):
        assert _max_err(a, ja) < TOL
    assert _max_err(agg, j_agg) < TOL and _max_err(x4, j_x4) < TOL
    cases = (("classic", "softmax"), ("classic", "sigmoid"), ("classic-gating", "softmax"),
             ("ae-squash", "softmax"), ("ae-extract", "softmax"))
    # one compiled function for all cases: XLA shares their common forward
    wants = jax.jit(lambda v, x: [jm.apply(v, x, method, mode, False,
                                           method=jseg.ResnestUNet.classification_predict)
                                  for mode, method in cases])(variables, jnp.asarray(x))
    for (mode, method), want in zip(cases, wants):
        with torch.no_grad():
            got = port.classification_predict(torch.from_numpy(x), method, mode)
        assert len(got) == len(want) == (4 if mode == "classic-gating" else 3), mode
        assert got[0].shape == (1, 2)
        assert _max_err(got[0], want[0]) < TOL, (mode, method)
        assert _max_err(got[-1], want[-1]) < TOL, (mode, method)


def test_heads_need_building():
    model = ResnestUNet(2)
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="heads=True"):
        model.classification_predict(x, "softmax", "classic")
    with pytest.raises(ValueError, match="encoder_gating"):
        model.classification_predict(x, "softmax", "classic-gating")


def test_parallel_head_matches_jax():
    _, variables = _filled("parallel_head")
    x = _nhwc_input(4)
    agg = _port_eval(_port_from_jax(ResnestUnetParallelHead(2), variables), x)
    want = _jax_apply(jseg.ResnestUnetParallelHead(num_classes=2), variables, x, train=False)
    assert agg.shape == want.shape == (2, 1, HW, HW, 2)
    assert _max_err(agg, want) < TOL


@pytest.mark.parametrize("gating_level", [4, 3])
def test_parallel_head_gate_matches_jax(gating_level):
    """Seven gates at level 4, six at 3 (depth 4's strict test), through the
    AAG and through the fused epilogue's plain version; a JAX tree without
    aag_4 (level 3) loads."""
    _, variables = _filled("parallel_head_gate", gating_level)
    if gating_level < 4:
        del variables["params"]["aag_4"]
    x = _nhwc_input(5)
    jm = jseg.ResnestUnetParallelHeadAttentionGate(num_classes=2, gating_level=gating_level)
    (j_atts, j_atts_c), j_agg = _jax_apply(jm, variables, x, train=False)
    assert len(j_atts) + len(j_atts_c) == {4: 7, 3: 6}[gating_level]
    for fused in (False, True):
        port = _port_from_jax(ResnestUnetParallelHeadAttentionGate(
            2, gating_level, use_fused_decoder=fused), variables)
        (atts, atts_c), agg = _port_eval(port, x)
        assert len(atts) == len(j_atts) and len(atts_c) == len(j_atts_c) == 2
        for a, ja in zip(atts + atts_c, tuple(j_atts) + tuple(j_atts_c)):
            assert a.shape == ja.shape and _max_err(a, ja) < TOL
        assert _max_err(agg, j_agg) < TOL


def test_bridge_round_trips_every_architecture():
    """fill -> convert_resnest_unet -> from_jax_variables gives back every
    tensor bit for bit, for each architecture and option; a stray leaf
    raises."""
    for args in (("unet", 4, True, True), ("parallel_head",), ("parallel_head_gate",)):
        sd, variables = _filled(*args)
        back = from_jax_variables(variables)
        want = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        assert set(back) == set(want), args
        for k, v in want.items():
            assert np.array_equal(back[k].numpy().view(np.uint32), v.view(np.uint32)), k
    variables = {**variables, "params": {**variables["params"], "stray": {"kernel": np.ones(1)}}}
    with pytest.raises(ValueError, match="stray"):
        from_jax_variables(variables)


def test_critic_pair_bridge():
    """The JAX trainer's {"main", "c"} critics -> the ModuleDict's keys."""
    manifest, meta, _ = load_fixture("disc64")
    sd = fill_state_dict(manifest)
    v = convert_discriminator(sd, depth=meta["depth"], instance_noise=True)
    both = from_jax_critics({"main": v["params"], "c": v["params"]},
                            {"main": v["spectral"], "c": v["spectral"]})
    assert set(both) == {f"{n}.{k}" for n in ("main", "c") for k in sd}
    for k, val in sd.items():
        assert np.array_equal(both[f"c.{k}"].numpy(), val), k
    with pytest.raises(ValueError, match="differ"):
        from_jax_critics({"main": v["params"]}, {"c": v["spectral"]})


def test_build_segmentor_rejects_bad_options():
    with pytest.raises(ValueError, match="unknown model.architecture"):
        build_segmentor("unet3d")
    with pytest.raises(ValueError, match="encoder gates"):
        build_segmentor("parallel_head_gate", encoder_gating=True)
