"""The rest of the JAX package's surface in the port, against the JAX package
on the CPU:

  * both kernels' plain versions in float16 against the Pallas kernels in
    float16 (interpret mode) at C = 32 and 256, to `kernel_tolerance`'s
    float16 rows. The JAX decoder epilogue rounds p0, p1, s and y to
    float16 on the way (octave_tpu/ops/pallas/decoder_epilogue.py:65-76),
    where the port computes in float32 and rounds once; so its gated output
    is held to the float16 rows against JAX's kernel run in float32 on the
    same float16 inputs and rounded once, and against JAX's float16 kernel
    to four float16 ulps of the largest output (ROADMAP C.6);
  * one float16 train step (`compute_dtype="float16"`, autocast, float32
    master weights, no loss scaling) against JAX's float16 step from the
    same converted weights at 32², B = 2, noise off: losses within 10%, the
    bound tests/test_torch_trainer.py holds the bf16 step to; and against the
    port's own float32 step;
  * `conv_transpose_2x2` under both lowerings against JAX's under both, at a
    non-square input with C_in != C_out, float32 to 1e-6; the int8
    ConvTranspose under both against JAX's int8 path;
  * `dice_score`, `auc_exact` (with ties) and `cl_dice` against JAX's to
    1e-12; `make_eval_step` against JAX's at 32² (pred 1e-5, metrics 1e-6);
  * `MetricsLogger`'s W&B and TensorBoard sinks through stand-in modules.
"""
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from goldens import fill_state_dict, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models.discriminator import DiscriminatorBlock as JaxD
from octave_tpu.models.segmentor import ResnestUNet as JaxUNet
from octave_tpu.ops import common as jcommon
from octave_tpu.ops import quant as jquant
from octave_tpu.ops.pallas.aag import fused_aag as jax_fused_aag
from octave_tpu.ops.pallas.decoder_epilogue import (
    fused_decoder_epilogue as jax_fused_decoder_epilogue,
)
from octave_tpu.train.state import TrainState as JaxState
from octave_tpu.train.steps import StepConfig as JaxStepConfig
from octave_tpu.train.steps import make_eval_step as jax_make_eval_step
from octave_tpu.train.steps import make_train_step as jax_make_train_step
from octave_tpu.utils import metrics as jmetrics
from octave_tpu.utils.torch_convert import convert_discriminator, convert_resnest_unet
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.data import preprocess as tpre
from octave_tpu_torch.models.discriminator import DiscriminatorBlock
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops import common as tcommon
from octave_tpu_torch.ops import quant as tquant
from octave_tpu_torch.ops.kernels import kernel_tolerance
from octave_tpu_torch.ops.kernels.aag import fused_aag
from octave_tpu_torch.ops.kernels.decoder_epilogue import fused_decoder_epilogue
from octave_tpu_torch.train import schedule as tsched
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.train.steps import StepConfig, compute_dtype, make_eval_step, make_train_step
from octave_tpu_torch.utils import metrics as tmetrics
from octave_tpu_torch.utils.convert import (
    from_jax_discriminator,
    from_jax_variables,
    load_reference_state_dict,
)
from octave_tpu_torch.utils.logging import MetricsLogger

F16 = torch.float16


def _within(got, want, tol, what):
    atol, rtol = tol
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    bad = d > atol + rtol * np.abs(want)
    assert not bad.any(), f"{what}: {bad.sum()} values over atol {atol} rtol {rtol}, max {d.max()}"


# -- float16 through both kernels' plain versions -----------------------------
@pytest.mark.parametrize("c", [32, 256])
def test_aag_float16_matches_pallas(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 9, 11, c)).astype(np.float16)
    w = (rng.standard_normal((c, 2)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(2) * 0.1).astype(np.float32)
    want = jax_fused_aag(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = fused_aag(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    for g, ref, tol, name in zip(got, want, kernel_tolerance("aag", F16, c), ("out", "y_hat")):
        assert g.dtype == F16 and ref.dtype == jnp.float16
        _within(g.float().numpy(), ref, tol, f"aag {name} C={c}")
    # the train path under autocast: float32 x read in float16, y_hat kept
    # in float32, x's gradient in float32 from x itself
    xt = torch.from_numpy(x).float().requires_grad_()
    out, yhat = fused_aag(xt, torch.from_numpy(w), torch.from_numpy(b), autocast_dtype=F16)
    assert out.dtype == F16 and torch.equal(out, got[0])
    assert torch.equal(yhat, fused_aag(torch.from_numpy(x).float(), torch.from_numpy(w),
                                       torch.from_numpy(b))[1])
    out.float().sum().backward()
    assert xt.grad.dtype == torch.float32
    with pytest.raises(TypeError):
        fused_aag(xt, torch.from_numpy(w), torch.from_numpy(b), autocast_dtype=torch.int8)


@pytest.mark.parametrize("c", [32, 256])
def test_decoder_epilogue_float16_matches_pallas(c):
    rng = np.random.default_rng(c + 1)
    z = rng.standard_normal((2, 9, 11, 2 * c)).astype(np.float16)
    attn = rng.standard_normal((2, 2 * c)).astype(np.float32)
    res = rng.standard_normal((2, 9, 11, c)).astype(np.float16)
    rest = [rng.uniform(0.5, 2, c), rng.uniform(-1, 1, c), rng.standard_normal((c, 2)) * 0.1,
            rng.standard_normal(2) * 0.1]
    rs, rb, w, b = (a.astype(np.float32) for a in rest)
    args16 = [z, attn, res, rs, rb, w, b]
    args32 = [a.astype(np.float32) for a in args16]
    got = fused_decoder_epilogue(*(torch.from_numpy(a) for a in args16))
    want16 = jax_fused_decoder_epilogue(*(jnp.asarray(a) for a in args16))
    want32 = jax_fused_decoder_epilogue(*(jnp.asarray(a) for a in args32))
    tol_out, tol_yhat = kernel_tolerance("decoder_epilogue", F16, c)
    assert got[0].dtype == got[1].dtype == F16
    _within(got[1].float().numpy(), want16[1], tol_yhat, f"y_hat C={c}")
    _within(got[0].float().numpy(), np.asarray(want32[0]).astype(np.float16), tol_out,
            f"out against the float32 kernel rounded once, C={c}")
    ulp = float(np.spacing(np.abs(np.asarray(want16[0])).max()))
    _within(got[0].float().numpy(), want16[0], (4 * ulp, 0.0), f"out C={c}")


# -- the float16 train step ---------------------------------------------------
HW, B, NF, DEPTH = 32, 2, 8, 4


def _grad_store():
    """An optax transformation that leaves the parameters be."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def golden_variables():
    """The golden fill of unet112 as JAX variables."""
    manifest, _, _ = load_fixture("unet112")
    return jax.tree.map(np.asarray, convert_resnest_unet(fill_state_dict(manifest)))


@pytest.fixture(scope="module")
def step_inputs(golden_variables):
    """The UNet's golden fill, a seeded critic (noise off) and one synthetic
    batch through the port's data path, as numpy."""
    seg = JaxUNet(num_classes=2)
    disc = JaxD(input_hw=(HW, HW), depth=DEPTH, num_filters=NF, instance_noise=False,
                label_noise=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        critic = DiscriminatorBlock((HW, HW), depth=DEPTH, num_filters=NF,
                                    instance_noise=False, label_noise=False)
    disc_vars = convert_discriminator({k: v.numpy() for k, v in critic.state_dict().items()},
                                      depth=DEPTH, instance_noise=False)
    host = next(tds.batch_iterator(tds.SyntheticOcta((HW, HW), n=4, seed=5), B, seed=2))
    batch = tpre.prepare_batch(host["image"], host["scribble"], host["mask"], size=(HW, HW),
                               num_classes=2, depth=DEPTH, in_channels=3, device="cpu")
    batch = {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy()
             for k, v in batch.items()}
    return seg, disc, golden_variables, jax.tree.map(np.asarray, disc_vars), batch


def _jax_losses(step_inputs, dtype):
    seg, disc, seg_vars, disc_vars, batch = step_inputs
    state = JaxState.create(seg_params=seg_vars["params"], disc_params=disc_vars["params"],
                            batch_stats=seg_vars["batch_stats"], spectral=disc_vars["spectral"],
                            seg_tx=_grad_store(), disc_tx=_grad_store())
    step = jax.jit(jax_make_train_step(seg, disc, JaxStepConfig(compute_dtype=dtype)))
    _, losses = step(state, jax.tree.map(jnp.asarray, batch))
    return {k: float(v) for k, v in losses.items()}


def _port_losses(step_inputs, dtype):
    _, _, seg_vars, disc_vars, batch = step_inputs
    seg = ResnestUNet(2)
    load_reference_state_dict(seg, from_jax_variables(seg_vars))
    critic = DiscriminatorBlock((HW, HW), depth=DEPTH, num_filters=NF, instance_noise=False,
                                label_noise=False)
    critic.load_state_dict(from_jax_discriminator(disc_vars, instance_noise=False))
    seg, critic = (m.to(memory_format=torch.channels_last) for m in (seg, critic))
    state = TrainState(segmentor=seg, seg_opt=tsched.make_optimizer(seg.parameters()),
                       critic=critic, critic_opt=tsched.make_optimizer(critic.parameters()),
                       generator=torch.Generator().manual_seed(0))
    tb = {k: tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
          else torch.from_numpy(v) for k, v in batch.items()}
    losses = make_train_step(StepConfig(compute_dtype=dtype))(state, tb)
    assert all(p.dtype == torch.float32 for p in state.segmentor.parameters())
    assert all(p.grad is None or p.grad.dtype == torch.float32
               for p in state.segmentor.parameters())
    return {k: v.item() for k, v in losses.items()}


def test_float16_step_matches_jax_float16_step(step_inputs):
    want = _jax_losses(step_inputs, "float16")
    got = _port_losses(step_inputs, "float16")
    ref = _port_losses(step_inputs, None)
    assert set(got) == set(want) == set(ref)
    for k, v in want.items():
        assert np.isfinite(got[k]) and np.isfinite(v), k
        assert abs(got[k] - v) <= 0.1 * abs(v) + 1e-3, (k, got[k], v)
        assert abs(got[k] - ref[k]) <= 0.1 * abs(ref[k]) + 1e-3, (k, got[k], ref[k])


def test_compute_dtype_names():
    assert compute_dtype(None) is None and compute_dtype("float32") is None
    assert compute_dtype("bfloat16") == torch.bfloat16 and compute_dtype("float16") == F16
    with pytest.raises(ValueError, match="'float16'"):
        compute_dtype("float64")
    with pytest.raises(ValueError):
        make_train_step(StepConfig(compute_dtype="int8"))


# -- the ConvTranspose lowering switch ----------------------------------------
@pytest.fixture
def both_switches():
    """Put both packages' switches back to 'native' after the test."""
    try:
        yield
    finally:
        jcommon.set_conv_transpose_impl("native")
        tcommon.set_conv_transpose_impl("native")


def _ct_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, c, o = 2, 5, 7, 6, 4
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kernel = rng.standard_normal((c, o, 2, 2)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return x, kernel, bias, xt


@pytest.mark.parametrize("impl", ["native", "einsum"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv_transpose_matches_jax(both_switches, impl, with_bias):
    x, kernel, bias, xt = _ct_inputs()
    jcommon.set_conv_transpose_impl(impl)
    tcommon.set_conv_transpose_impl(impl)
    assert tcommon.conv_transpose_impl() == impl
    want = jcommon.conv_transpose_2x2(jnp.asarray(x), jnp.asarray(kernel),
                                      jnp.asarray(bias) if with_bias else None)
    got = tcommon.conv_transpose_2x2(xt, torch.from_numpy(kernel),
                                     torch.from_numpy(bias) if with_bias else None)
    assert got.shape == (2, 4, 10, 14) and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_conv_transpose_impl_is_checked(both_switches):
    with pytest.raises(ValueError, match="einsum"):
        tcommon.set_conv_transpose_impl("dense")
    assert tcommon.conv_transpose_impl() == "native"


@pytest.mark.parametrize("impl", ["native", "einsum"])
def test_int8_conv_transpose_matches_jax(both_switches, impl):
    x, kernel, bias, xt = _ct_inputs(1)
    sx = float(np.abs(x).max()) / 127.0
    jcommon.set_conv_transpose_impl(impl)
    tcommon.set_conv_transpose_impl(impl)
    want = jquant.int8_conv_transpose_2x2(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                          sx)
    got = tquant.int8_conv_transpose_2x2(xt, torch.from_numpy(kernel), torch.from_numpy(bias),
                                         sx)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_predictor_follows_the_switch(both_switches):
    from octave_tpu_torch.serve import Predictor

    pred = Predictor.initialize(dtype=torch.float32, device="cpu")
    images = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    native = pred(images)
    tcommon.set_conv_transpose_impl("einsum")
    np.testing.assert_allclose(pred(images), native, atol=1e-5, rtol=0)


# -- host metrics and the eval step -------------------------------------------
def test_dice_auc_cl_dice_match_jax():
    rng = np.random.default_rng(11)
    pred = rng.uniform(size=(2, 40, 40)) > 0.6
    target = rng.uniform(size=(2, 40, 40)) > 0.5
    want = float(jmetrics.dice_score(jnp.asarray(pred), jnp.asarray(target)))
    got = tmetrics.dice_score(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=0, atol=1e-12)
    scores = np.round(rng.uniform(size=500), 2)  # ties
    labels = rng.uniform(size=500) > 0.7
    np.testing.assert_allclose(tmetrics.auc_exact(scores, labels),
                               jmetrics.auc_exact(scores, labels), rtol=0, atol=1e-12)
    assert np.isnan(tmetrics.auc_exact(scores, np.zeros(500, bool)))
    yy, xx = np.mgrid[:48, :48]
    vessels = (np.abs(yy - 0.6 * xx - 5) < 2) | (np.abs(xx - 30) < 3)
    noisy = vessels ^ (rng.uniform(size=vessels.shape) > 0.97)
    for p, t in ((noisy, vessels), (pred[0], target[0]), (vessels, vessels)):
        np.testing.assert_allclose(tmetrics.cl_dice(p, t), jmetrics.cl_dice(p, t), rtol=0,
                                   atol=1e-12)


def test_eval_step_matches_jax(golden_variables):
    variables = golden_variables
    rng = np.random.default_rng(12)
    image = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, HW, HW)) > 0.5).astype(np.float32)
    onehot = np.stack([1 - mask, mask], -1)
    want_pred, want = jax.jit(jax_make_eval_step(JaxUNet(num_classes=2)))(
        variables["params"], variables["batch_stats"],
        {"image": jnp.asarray(image), "mask_onehot": jnp.asarray(onehot)})
    seg = ResnestUNet(2)
    load_reference_state_dict(seg, from_jax_variables(variables))
    seg = seg.to(memory_format=torch.channels_last).train()
    pred, got = make_eval_step(2)(seg, {"image": torch.from_numpy(image),
                                        "mask_onehot": torch.from_numpy(onehot)})
    assert seg.training  # the mode is put back
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=1e-5, rtol=0)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), atol=1e-6, rtol=0, err_msg=k)


# -- MetricsLogger's sinks ------------------------------------------------------
class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **kw: self.calls.append((name, a, kw))


def test_logger_sinks_reach_stand_ins(tmp_path, monkeypatch):
    wandb = types.ModuleType("wandb")
    run = _Recorder()
    for name in ("init", "log", "finish"):
        setattr(wandb, name, getattr(run, name))
    writers = []

    class SummaryWriter(_Recorder):
        def __init__(self, log_dir):
            super().__init__()
            self.log_dir = log_dir
            writers.append(self)

    tbx = types.ModuleType("tensorboardX")
    tbx.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # falls to tensorboardX
    monkeypatch.setitem(sys.modules, "tensorboardX", tbx)
    logger = MetricsLogger(str(tmp_path), use_wandb=True, use_tensorboard=True, project="p",
                           run_name="r", config={"lr": 1e-3})
    logger.log(3, {"loss": 0.5}, prefix="train/")
    logger.close()
    assert run.calls[0] == ("init", (), {"project": "p", "name": "r", "config": {"lr": 1e-3}})
    name, (record,), kw = run.calls[1]
    assert name == "log" and kw == {"step": 3} and record["train/loss"] == 0.5
    assert run.calls[2][0] == "finish"
    assert len(writers) == 1 and writers[0].log_dir == str(tmp_path)
    assert writers[0].calls == [("add_scalar", ("train/loss", 0.5, 3), {}), ("close", (), {})]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["train/loss"] == 0.5 and json.loads(lines[0])["step"] == 3


def test_logger_without_the_packages_keeps_the_jsonl(tmp_path, monkeypatch):
    for mod in ("wandb", "torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    logger = MetricsLogger(str(tmp_path), use_wandb=True, use_tensorboard=True)
    logger.log(1, {"dice": 0.25})
    logger.close()
    assert [p.name for p in tmp_path.iterdir()] == ["metrics.jsonl"]
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["dice"] == 0.25
    MetricsLogger().close()  # no log_dir: no sink at all
