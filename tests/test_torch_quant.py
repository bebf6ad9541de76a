"""The port's int8 post-training quantisation (octave_tpu_torch/ops/quant.py)
against the JAX package's (octave_tpu/ops/quant.py) on the CPU.

The int8 ops must equal JAX's bit for bit, in float32 and in bf16: the
weight and activation quantisation are the same float32 expressions, the
int8 x int8 products accumulate exactly in int32 on both sides, and the
dequantisation is elementwise. Inputs are numpy from a seed, rounded to the
dtype first, NHWC on the JAX side and NCHW on the port's.

The serving path is held against the JAX Predictor on the golden fill of
tests/goldens.py at 64², float32, B = 2, both calibrated on the same batch:
per scope, the port's scale keys equal `scales_from_jax` of JAX's, with
values within 1e-5 relative; and the int8 Predictors (fused decoder; the
JAX Pallas kernel in interpret mode, the port's plain version) agree on the
argmax of >= 0.999 of pixels with mean |p difference| <= 1e-3. Observed:
agreement 1.0, mean |dp| 3.3e-5, max 3.7e-4 (scope decoder).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import fill_state_dict, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.ops import common as jcommon
from octave_tpu.ops import quant as jq
from octave_tpu.serve import Predictor as JaxPredictor
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops import quant as tq
from octave_tpu_torch.serve import INT8_SCOPES, Predictor
from octave_tpu_torch.utils.convert import from_jax_variables, scales_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (C_in, C_out, kernel, stride, padding, groups, H = W)
CONVS = {"3x3": (16, 24, 3, 1, 1, 1, 9), "1x1": (16, 24, 1, 1, 0, 1, 9),
         "stride2": (16, 24, 3, 2, 1, 1, 9), "groups4": (16, 24, 3, 1, 1, 4, 8),
         "cin3": (3, 32, 3, 2, 1, 1, 10)}


def _both(a: np.ndarray, dtypes, layout=None):
    """(JAX array, torch tensor) of the same values in the dtype; `layout`
    permutes the torch side (NHWC -> NCHW, HWIO -> OIHW)."""
    j = jnp.asarray(a).astype(dtypes[0])
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    if layout is not None:
        t = t.permute(*layout)
    return j, t.to(dtypes[1])


def _np(t: torch.Tensor, layout=(0, 2, 3, 1)) -> np.ndarray:
    return t.permute(*layout).float().numpy()


def _conv_case(rng, case, dtypes):
    ci, co, k, s, p, g, hw = CONVS[case]
    x = _both(rng.standard_normal((2, hw, hw, ci)) * 2, dtypes, (0, 3, 1, 2))
    w = _both(rng.standard_normal((k, k, ci // g, co)) * 0.1, dtypes, (3, 2, 0, 1))
    b = _both(rng.standard_normal(co), dtypes)
    sx = float(np.abs(np.asarray(x[0], np.float32)).max() / 127 * 0.9)  # some clipping
    return x, w, b, sx, dict(s=s, p=p, g=g)


@pytest.mark.parametrize("dt", DTYPES)
def test_quantize_weight_matches_jax(rng, dt):
    w = _both(rng.standard_normal((3, 3, 16, 24)), DTYPES[dt], (3, 2, 0, 1))
    jwq, jws = jq.quantize_weight(w[0])
    twq, tws = tq.quantize_weight(w[1])
    np.testing.assert_array_equal(twq.permute(2, 3, 1, 0).numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    # the ConvTranspose layout (C_in, C_out, 2, 2) keeps C_out
    wt = _both(rng.standard_normal((16, 8, 2, 2)), DTYPES[dt])
    jwq, jws = jq.quantize_weight(jnp.transpose(wt[0], (2, 3, 0, 1)))
    twq, tws = tq.quantize_weight(wt[1], transpose=True)
    np.testing.assert_array_equal(twq.numpy(), np.transpose(np.asarray(jwq), (2, 3, 0, 1)))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


@pytest.mark.parametrize("case", CONVS)
@pytest.mark.parametrize("dt", DTYPES)
def test_int8_conv_matches_jax(rng, dt, case):
    x, w, b, sx, c = _conv_case(rng, case, DTYPES[dt])
    p = c["p"]
    want = jq.int8_conv(x[0], w[0], b[0], sx, strides=(c["s"], c["s"]),
                        padding=[(p, p), (p, p)], groups=c["g"])
    got = tq.int8_conv(x[1], w[1], b[1], sx, c["s"], p, 1, c["g"])
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["native", "einsum"])
@pytest.mark.parametrize("dt", DTYPES)
def test_int8_conv_transpose_matches_both_jax_lowerings(rng, dt, impl, monkeypatch):
    x = _both(rng.standard_normal((2, 5, 7, 16)), DTYPES[dt], (0, 3, 1, 2))
    w = _both(rng.standard_normal((16, 8, 2, 2)) * 0.1, DTYPES[dt])
    b = _both(rng.standard_normal(8), DTYPES[dt])
    sx = float(np.abs(np.asarray(x[0], np.float32)).max() / 127)
    monkeypatch.setattr(jcommon, "_CONV_TRANSPOSE_IMPL", impl)
    want = jq.int8_conv_transpose_2x2(x[0], w[0], b[0], sx)
    got = tq.int8_conv_transpose_2x2(x[1], w[1], b[1], sx)
    assert got.shape == (2, 8, 10, 14)
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dt", DTYPES)
def test_prepacked_equals_per_call(rng, dt):
    """An int8 weight with a PackedScale, and an Int8Conv built with
    prepack, compute exactly what the per-call quantisation does."""
    x, w, b, sx, c = _conv_case(rng, "groups4", DTYPES[dt])
    wq, ws = tq.quantize_weight(w[1])
    per_call = tq.int8_conv(x[1], w[1], b[1], sx, 1, 1, 1, 4)
    packed = tq.int8_conv(x[1], wq, b[1], tq.PackedScale(sx, ws), 1, 1, 1, 4)
    assert torch.equal(packed, per_call)
    conv = torch.nn.Conv2d(16, 24, 3, padding=1, groups=4).to(DTYPES[dt][1])
    with torch.no_grad():
        conv.weight.copy_(w[1])
        conv.bias.copy_(b[1])
        for prepack in (True, False):
            assert torch.equal(tq.Int8Conv(conv, sx, prepack)(x[1]), per_call)
    wt = _both(rng.standard_normal((24, 8, 2, 2)) * 0.1, DTYPES[dt])[1]
    wtq, wts = tq.quantize_weight(wt, transpose=True)
    up = torch.nn.ConvTranspose2d(24, 8, 2, 2, bias=False).to(DTYPES[dt][1])
    with torch.no_grad():
        up.weight.copy_(wt)
        want = tq.int8_conv_transpose_2x2(per_call, wt, None, 0.01)
        assert torch.equal(tq.int8_conv_transpose_2x2(
            per_call, wtq, None, tq.PackedScale(0.01, wts)), want)
        assert torch.equal(tq.Int8Conv(up, 0.01)(per_call), want)


@pytest.mark.parametrize("prepack", [True, False], ids=["prepacked", "per_call"])
@pytest.mark.parametrize("dt", DTYPES)
def test_decoder_pair_matches_jax(rng, dt, prepack):
    """A decoder's first conv on the (skip, up) pair: one int8 conv per half
    with its own activation scale, each dequantised and cast to the input
    dtype, then added (octave_tpu/models/resnest.py:798-808). Per call,
    each half of the kernel is quantised on its own; prepacked, the whole
    kernel once, as `prepack_weights` does."""
    a = _both(rng.standard_normal((2, 6, 6, 8)) * 3, DTYPES[dt], (0, 3, 1, 2))
    b = _both(rng.standard_normal((2, 6, 6, 16)), DTYPES[dt], (0, 3, 1, 2))
    k = _both(rng.standard_normal((3, 3, 24, 16)) * 0.1, DTYPES[dt], (3, 2, 0, 1))
    sa, sb = 3 * 3.5 / 127, 3.5 / 127
    pad = [(1, 1), (1, 1)]
    if prepack:
        wq, ws = jq.quantize_weight(k[0])
        want = (jq.int8_conv(a[0], wq[:, :, :8], None, jq.PackedScale(sa, ws), padding=pad)
                + jq.int8_conv(b[0], wq[:, :, 8:], None, jq.PackedScale(sb, ws), padding=pad))
    else:
        want = (jq.int8_conv(a[0], k[0][:, :, :8], None, sa, padding=pad)
                + jq.int8_conv(b[0], k[0][:, :, 8:], None, sb, padding=pad))
    conv = torch.nn.Conv2d(24, 16, 3, padding=1, bias=False).to(DTYPES[dt][1])
    with torch.no_grad():
        conv.weight.copy_(k[1])
        q = tq.Int8Conv(conv, (sa, sb), prepack)
        got = q((a[1], b[1]))
        assert q.takes_pair and torch.equal(q((a[1], b[1])), got)  # the cached halves
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", [(1, 27, 2), (5, 32, 30), (16, 24, 8), (17, 40, 64),
                                   (40, 9, 13)])
def test_int8_mm_pads_exactly(rng, m, k, n):
    """CUDA's _int_mm needs more than 16 rows and K, N in multiples of 8:
    the zero padding changes no product."""
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = tq.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# -- the serving path -----------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """The golden fill as JAX variables and the port's state dict, a
    calibration batch and request images (uint8, 64², B = 2), the JAX
    calibration's statistics (run once; its scopes filter them) and the
    JAX int8 Predictor's probabilities (decoder scope, fused decoder)."""
    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    rng = np.random.default_rng(7)
    calib = (rng.uniform(0, 1, (2, 64, 64, 3)) * 255).astype(np.uint8)
    images = (rng.uniform(0, 1, (2, 64, 64, 3)) * 255).astype(np.uint8)
    kw = dict(dtype=jnp.float32, use_fused_decoder=True, int8_decoder=True,
              calibration_batches=[calib])
    stats = {}
    calibrate = jq.calibrate

    def once(*args):
        if not stats:
            stats.update(calibrate(*args))
        return stats

    jq.calibrate = once
    try:
        per_call = JaxPredictor(variables, int8_prepack=False, **kw)  # float weights
        jax_scales = {scope: per_call._calibrate([calib], scope) for scope in INT8_SCOPES}
        with pytest.raises(ValueError) as jax_error:
            per_call._calibrate([calib], "bogus")
        jax_pred = JaxPredictor(variables, **kw)
    finally:
        jq.calibrate = calibrate
    return dict(variables=variables, sd=from_jax_variables(variables), calib=calib,
                images=images, jax_scales=jax_scales, jax_probs=jax_pred(images),
                jax_error=str(jax_error.value))


def _port(served, **kw):
    return Predictor(served["sd"], dtype=torch.float32, device="cpu", int8_decoder=True,
                     calibration_batches=[served["calib"]], **kw)


@pytest.mark.parametrize("scope", list(INT8_SCOPES))
def test_scale_keys_match_jax(served, scope):
    """33 scales in scope decoder (seven at each of depths 1-4, five at
    depth 0), 38 with the upsamplings; every scope selects what JAX's
    selects, and calibrates the same maxima."""
    want = scales_from_jax(served["jax_scales"][scope])
    got = _port(served, int8_scope=scope).int8_scales
    assert set(got) == set(want)
    assert len(got) == {"decoder": 33, "decoder+ups": 38}.get(scope, len(want))
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, k


def test_scales_from_jax_maps_only_the_ports_convs():
    got = scales_from_jax({"decoder_0/conv1/in_absmax": 0.5, "decoder_2/conv1_b_absmax": 0.25,
                           "upsampling_4/in_absmax": 0.125,
                           "backbone/layer3_1/conv2/fc1/in_absmax": 1.0})
    assert got == {"decoder_0.conv.0": 0.5, "decoder_2.conv.0:b": 0.25,
                   "upsampling_4.up": 0.125, "encoder_3.1.conv2.fc1": 1.0}
    for bad in ("decoder_9/conv1/in_absmax", "decoder_0/conv7_a_absmax", "fc/out_absmax"):
        with pytest.raises(KeyError, match="no module of the port"):
            scales_from_jax({bad: 1.0})


def test_int8_predictor_matches_jax(served):
    port = _port(served)
    tq.int8_mm.launches = 0
    got = port(served["images"])
    assert tq.int8_mm.launches == 33  # one GEMM a scale: a pair conv runs two
    want = served["jax_probs"]
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    mean_dp = float(np.abs(got - want).mean())
    print(f"int8 port vs JAX: argmax agreement {agree}, mean |dp| {mean_dp:.3g}, "
          f"max {np.abs(got - want).max():.3g}")
    assert got.shape == want.shape and agree >= 0.999 and mean_dp <= 1e-3
    # predict_many and its stacks run the same int8 model
    np.testing.assert_array_equal(port.predict_many(served["images"][None])[0], got)


def test_int8_arguments_raise_before_any_build(served, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("built a model")

    monkeypatch.setattr("octave_tpu_torch.serve.ResnestUNet", no_build)
    with pytest.raises(ValueError, match="calibration_batches"):
        Predictor(served["sd"], device="cpu", int8_decoder=True)
    with pytest.raises(ValueError) as err:
        Predictor(served["sd"], device="cpu", int8_decoder=True, int8_scope="bogus",
                  calibration_batches=[served["calib"]])
    assert str(err.value) == served["jax_error"]


def test_state_dict_keys_survive_quantisation(served):
    """Quantisation keeps every state-dict key; prepacked weights are int8
    under the same names."""
    fresh = ResnestUNet(2, use_fused_decoder=True).state_dict()
    for prepack in (True, False):
        sd = _port(served, int8_scope="all", int8_prepack=prepack).model.state_dict()
        assert list(sd) == list(fresh)
        assert (sd["decoder_3.conv.0.weight"].dtype == torch.int8) == prepack
        assert sd["aag_3.conv1.weight"].dtype == torch.float32  # the kernel takes the gate


@pytest.mark.slow
def test_int8_scopes_shift_as_jax_at_304():
    """On the committed trained weights at 304², bf16, B = 2, calibrated on
    other phantoms than the requests (chip_smoke.py's): each int8 scope
    moves the port's masks off its bf16 masks as far as it moves the JAX
    package's (agreement within 0.005), and the port's int8 masks agree
    with JAX's on >= 0.99 of pixels. Observed on the CPU: scope decoder,
    port 0.99679 / JAX 0.99676 of pixels with bf16, port with JAX 0.99720;
    scope all, port 0.98880 / JAX 0.98863, port with JAX 0.99061. Scope all
    sits under the 0.99 gate of the decoder scope in both packages."""
    from chip_smoke import phantoms
    from octave_tpu.utils.checkpoint import load_weights_npz

    variables = load_weights_npz(os.path.join(ROOT, "benchmarks", "weights304.npz"))
    sd = from_jax_variables(variables)
    calib, images = phantoms(2, 304, seed=31), phantoms(2, 304, seed=11)

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).mean())

    jax_bf16 = JaxPredictor(variables, use_fused_decoder=True)(images)
    port_bf16 = Predictor(sd, device="cpu")(images)
    for scope in ("decoder", "all"):
        j8 = JaxPredictor(variables, use_fused_decoder=True, int8_decoder=True,
                          calibration_batches=[calib], int8_scope=scope)(images)
        t8 = Predictor(sd, device="cpu", int8_decoder=True, calibration_batches=[calib],
                       int8_scope=scope)(images)
        shifts = agree(t8, port_bf16), agree(j8, jax_bf16)
        print(f"scope {scope}: int8 vs bf16 masks, port {shifts[0]:.5f}, JAX {shifts[1]:.5f}; "
              f"port vs JAX int8 {agree(t8, j8):.5f}")
        assert abs(shifts[0] - shifts[1]) <= 0.005 and agree(t8, j8) >= 0.99, scope
