"""The port's ResnestUNet and Predictor: the reference goldens and the JAX
Predictor, on the CPU.

The golden fixtures hold the original PyTorch reference's float32 outputs on
the deterministic fill (tests/goldens.py); the reference-named fill loads
straight into the port. Tolerance 1e-3, as tests/test_golden.py. The
Predictor comparison runs the JAX package's Predictor (float32, folded BN,
fused decoder) and the port's on the same converted weights and images.
"""
import os

import numpy as np
import pytest
import torch

from goldens import fill_state_dict, input_array, load_fixture
from octave_tpu_torch.models.segmentor import ResnestUNet, apply_prediction_method
from octave_tpu_torch.serve import Predictor
from octave_tpu_torch.utils.convert import from_jax_variables, load_reference_state_dict


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _golden(name, fused):
    manifest, meta, out = load_fixture(name)
    model = ResnestUNet(2, gating_level=meta["gating_level"], use_fused_decoder=fused)
    load_reference_state_dict(model, fill_state_dict(manifest))
    model.eval().to(memory_format=torch.channels_last)
    hw = meta["hw"]
    x = torch.from_numpy(input_array(meta["seed"], (1, 3, hw, hw))).permute(0, 2, 3, 1)
    with torch.no_grad():
        atts, agg, x4 = model(x.contiguous())
    nchw = lambda t: t.permute(0, 3, 1, 2).numpy()  # noqa: E731
    assert len(atts) == 5
    for i, a in enumerate(atts):
        assert _max_err(out[f"att{i}"], nchw(a)) < 1e-3, f"attention {i}"
    pred = apply_prediction_method(agg, "softmax")
    assert _max_err(out["pred"], nchw(pred)) < 1e-3, "pred"
    if "x4" in out:
        assert _max_err(out["agg"], nchw(agg)) < 1e-3, "agg"
        assert _max_err(out["x4"], nchw(x4)) < 1e-3, "x4"


@pytest.mark.parametrize("fused", [False, True], ids=["aag", "fused"])
def test_golden_unet112(fused):
    _golden("unet112", fused)


@pytest.mark.slow
@pytest.mark.parametrize("fused", [False, True], ids=["aag", "fused"])
def test_golden_unet304(fused):
    _golden("unet304", fused)


def test_gating_level_and_methods():
    manifest, _, _ = load_fixture("unet112")
    sd = fill_state_dict(manifest)
    model = ResnestUNet(2, gating_level=-1, use_fused_decoder=True)
    load_reference_state_dict(model, sd)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        atts, agg, x4 = model.eval()(x)
        _, hot = model.predict(x, "one-hot")
    assert atts == () and agg.shape == (1, 32, 32, 2) and x4.shape == (1, 1, 1, 2048)
    assert torch.equal(hot.sum(-1), torch.ones(1, 32, 32))
    with pytest.raises(ValueError, match="bogus"):
        apply_prediction_method(agg, "bogus")


@pytest.fixture(scope="module")
def unet_weights():
    """Golden fill, as the JAX variables and as the port's state dict."""
    from octave_tpu.utils.torch_convert import convert_resnest_unet

    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    return variables, from_jax_variables(variables)


@pytest.mark.parametrize("fmt", ["prob_f32", "mask_u8"])
def test_predictor_matches_jax_predictor(unet_weights, fmt):
    import jax.numpy as jnp

    from octave_tpu.serve import Predictor as JaxPredictor

    variables, sd = unet_weights
    images = (np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)) * 255).astype(np.uint8)
    want = JaxPredictor(variables, dtype=jnp.float32, use_fused_decoder=True, fold_bn=True,
                        output_format="prob_f32")(images)
    port = Predictor(sd, dtype=torch.float32, fold_bn=True, output_format=fmt, device="cpu")
    got = port(images)
    if fmt == "prob_f32":
        err = _max_err(got, want)
        print(f"port vs JAX Predictor, prob_f32 max |err| = {err:.3g}")
        assert got.shape == want.shape and err < 1e-4
    else:
        # pixels whose probability sits within 1e-4 of the 0.5 cut may flip
        decided = np.abs(want[..., 1] - 0.5) > 1e-4
        expect = np.where(want[..., 1] >= 0.5, 255, 0)
        print(f"port vs JAX Predictor, mask_u8 disagreements: "
              f"{int((got != expect)[decided].sum())} of {decided.sum()} decided pixels")
        assert got.dtype == np.uint8 and np.array_equal(got[decided], expect[decided])


def test_predict_many_matches_calls(unet_weights):
    _, sd = unet_weights
    port = Predictor(sd, dtype=torch.float32, output_format="prob_f16", device="cpu")
    stack = (np.random.default_rng(3).uniform(0, 1, (2, 1, 32, 32, 3)) * 255).astype(np.uint8)
    many = port.predict_many(stack)
    assert many.shape == (2, 1, 32, 32, 2) and many.dtype == np.float16
    for i in range(2):
        np.testing.assert_array_equal(many[i], port(stack[i]))


def test_predictor_defaults_to_cuda(unet_weights):
    _, sd = unet_weights
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(sd)
    with pytest.raises(ValueError, match="output_format"):
        Predictor(sd, output_format="png", device="cpu")


@pytest.mark.slow
def test_bf16_mask_agreement_matches_jax():
    """bf16 serving masks agree with the float32 masks as often in the port
    as in the JAX package (trained weights, 304² vessel phantoms). This is
    the measurement behind chip_smoke.py's MASK_AGREEMENT_FLOOR."""
    import jax.numpy as jnp

    import chip_smoke
    from octave_tpu.serve import Predictor as JaxPredictor
    from octave_tpu.utils.checkpoint import load_weights_npz as jax_load
    from octave_tpu_torch.utils.checkpoint import load_weights_npz

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "weights304.npz")
    images = chip_smoke.phantoms(4, 304, seed=11)
    sd = from_jax_variables(load_weights_npz(path))
    port = {dt: Predictor(sd, dtype=dt, output_format="mask_u8", device="cpu")(images)
            for dt in (torch.float32, torch.bfloat16)}
    jv = jax_load(path)
    ref = {dt: JaxPredictor(jv, dtype=dt, output_format="mask_u8")(images)
           for dt in (jnp.float32, jnp.bfloat16)}
    port_agree = float((port[torch.float32] == port[torch.bfloat16]).mean())
    jax_agree = float((ref[jnp.float32] == ref[jnp.bfloat16]).mean())
    print(f"bf16 vs float32 mask agreement: port {port_agree:.5f}, JAX {jax_agree:.5f}")
    assert np.array_equal(port[torch.float32], ref[jnp.float32])
    assert port_agree >= chip_smoke.MASK_AGREEMENT_FLOOR
    assert abs(port_agree - jax_agree) < 1e-3
