"""The port's memory and lowering switches against the JAX package on the CPU.

  * The spec parsers (`train.remat`, `dense_groups` / `einsum_groups`) return
    what the JAX parsers return on the same specs and raise the same errors,
    and each lowering spec selects the convs JAX's selects (JAX's module
    paths mapped to the port's names by `utils/convert.py`'s table).
  * `grouped_conv_einsum` and the block-diagonal dense lowering equal the JAX
    lowerings in float64 (values, input and weight gradients, 1e-12), and the
    lowered Predictors the JAX Predictors with the same argument at 64²
    (float32, atol 1e-5 as tests/test_serve.py holds JAX's einsum Predictor).
  * The bf16-moment optimizer equals optax's adam / adamw(mu_dtype=bf16) over
    5 steps (mu within one bf16 ulp, nu and the parameters within 1e-6
    relative), and a checkpoint round trip keeps `exp_avg` in bf16 and the
    next step bit-exact.
  * Bad specs raise before anything is built; `Trainer.init_state` wires
    every switch into the model and the optimizers.
Remat, steps_per_call and the trainer runs: tests/test_torch_remat.py.
At 32² (64² for the Predictors), B = 2, on two PyTorch threads.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from goldens import fill_state_dict, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models import resnest as jresnest
from octave_tpu.models.segmentor import ResnestUNet as JaxUNet
from octave_tpu.models.segmentor import ResnestUnetParallelHeadAttentionGate as JaxPHG
from octave_tpu.serve import Predictor as JaxPredictor
from octave_tpu.train import schedule as jsched
from octave_tpu.train import trainer as jtrainer
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.models import resnest as tresnest
from octave_tpu_torch.models.segmentor import build_segmentor
from octave_tpu_torch.serve import Predictor
from octave_tpu_torch.train import schedule as tsched
from octave_tpu_torch.train import trainer as ttrainer
from octave_tpu_torch.train.steps import StepConfig, make_train_step
from octave_tpu_torch.utils import checkpoint as tckpt
from octave_tpu_torch.utils.config import Config
from octave_tpu_torch.utils.convert import _ConvNames, _walk_segmentor, from_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
SMALL = {"train.steps": "2", "data.image_size": "[32,32]", "data.synthetic_n": "4",
         "data.batch_size": "2", "train.eval_every": "0", "train.log_every": "0",
         "model.instance_noise": "false", "model.label_noise": "false"}


def _cfg(**extra):
    return Config.load(SMOKE).apply_overrides({**SMALL, **extra})


def _outcome(fn, spec):
    try:
        return ("value", fn(spec))
    except ValueError as e:
        return ("ValueError", str(e))


# -- the spec parsers ---------------------------------------------------------
REMAT_SPECS = [False, True, "conv", "block", "block-enc", "block:012", "block:4",
               "block+conv", "block:034+conv", "block:012e12", "block:01234e34+conv",
               "block:", "block:05", "blockx", "block:012e05", "block:012e", "block:e12"]


@pytest.mark.parametrize("spec", REMAT_SPECS, ids=str)
def test_remat_parsers_match_jax(spec):
    for name in ("_parse_remat_blocks", "_parse_remat_enc_layers", "_remat_saves_convs"):
        want = _outcome(getattr(jtrainer, name), spec)
        assert _outcome(getattr(ttrainer, name), spec) == want, name


GROUP_SPECS = ["all", "decoder", "decoder:01", "decoder:1", "decoder:234+enc", "enc",
               "enc+decoder:4", "decoder:", "decoder:x1", "bogus", "", "decoder:234+bogus"]


@pytest.mark.parametrize("spec", GROUP_SPECS)
def test_dense_groups_errors_match_jax(spec):
    j, t = _outcome(jresnest.dense_groups_include, spec), \
        _outcome(tresnest.dense_groups_include, spec)
    assert j[0] == t[0] and (j[0] == "value" or j[1] == t[1]), (j, t)


def _jax_grouped_conv_paths(model):
    """The module path of every grouped Conv a JAX segmentor's init calls."""
    paths = set()

    def record(next_fun, args, kwargs, context):
        m = context.module
        if isinstance(m, jresnest.Conv) and context.method_name == "__call__" and m.groups > 1:
            paths.add(tuple(m.scope.path))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                          False))
    return paths


@pytest.fixture(scope="module")
def jax_grouped():
    names = _ConvNames()
    _walk_segmentor(names)
    return {arch: {names.names[p + ("conv",)]: "/".join(p) for p in _jax_grouped_conv_paths(m)}
            for arch, m in (("unet", JaxUNet(num_classes=2)),
                            ("parallel_head_gate", JaxPHG(num_classes=2, gating_level=4)))}


@pytest.mark.parametrize("arch", ["unet", "parallel_head_gate"])
@pytest.mark.parametrize("spec", ["all", "decoder", "decoder:01", "decoder:1",
                                  "decoder:234+enc", "enc"])
def test_lowering_selects_the_convs_jax_selects(jax_grouped, arch, spec):
    jax_paths = jax_grouped[arch]  # port name -> JAX module path
    include = jresnest.dense_groups_include(spec)
    want = {n for n, p in jax_paths.items() if include is None or include(p)}
    for lowering, cls in (("dense", tresnest.DenseGroupsConv2d),
                          ("einsum", tresnest.EinsumGroupsConv2d)):
        with torch.device("meta"):
            model = build_segmentor(arch, 2, 4)
        grouped = {n for n, m in model.named_modules()
                   if isinstance(m, torch.nn.Conv2d) and m.groups > 1}
        assert grouped == set(jax_paths)
        keys = list(model.state_dict())
        tresnest.lower_grouped_convs_(model, **{lowering: spec})
        assert {n for n, m in model.named_modules() if isinstance(m, cls)} == want
        assert list(model.state_dict()) == keys


def test_einsum_wins_where_both_select():
    with torch.device("meta"):
        model = build_segmentor("unet", 2, 4)
    tresnest.lower_grouped_convs_(model, dense="decoder", einsum="decoder:0+enc")
    kinds = {n: type(m).__name__ for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d) and m.groups > 1}
    assert kinds["decoder_0.conv.3.conv"] == kinds["encoder_1.0.conv2.conv"] \
        == "EinsumGroupsConv2d"
    assert kinds["decoder_1.conv.3.fc1"] == "DenseGroupsConv2d"


# -- the lowerings in float64 ---------------------------------------------------
# (C_in, C_out, kernel, stride, padding, dilation, groups, bias, H): the
# encoder SplAt conv (groups 2, no bias), the decoder's (groups 4), its fc1,
# and a strided, dilated case
LOWER_CASES = {"enc_splat": (16, 32, 3, 1, 1, 1, 2, False, 9),
               "dec_splat": (16, 32, 3, 1, 1, 1, 4, True, 8),
               "fc1": (8, 32, 1, 1, 0, 1, 2, True, 1),
               "strided_dilated": (12, 18, 3, 2, 2, 2, 3, True, 11)}


@pytest.mark.parametrize("lowering", ["dense", "einsum"])
@pytest.mark.parametrize("case", list(LOWER_CASES))
def test_lowering_matches_jax_in_float64(lowering, case):
    cin, cout, k, s, p, d, g, bias, hw = LOWER_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, hw, hw, cin))
    kern = rng.standard_normal((k, k, cin // g, cout)) * 0.3
    b = rng.standard_normal(cout) if bias else None
    ho = (hw + 2 * p - d * (k - 1) - 1) // s + 1
    ct = rng.standard_normal((2, ho, ho, cout))
    conv = jresnest.Conv(cout, k, s, p, dilation=d, groups=g, use_bias=bias)
    switch = jresnest.groups_as_dense if lowering == "dense" else jresnest.groups_as_einsum
    with jax.enable_x64():
        params = {"conv": {"kernel": jnp.asarray(kern)}}
        if bias:
            params["conv"]["bias"] = jnp.asarray(b)

        def f(xx, pp):
            with switch():
                return conv.apply({"params": pp}, xx)

        y, vjp = jax.vjp(f, jnp.asarray(x), params)
        gx, gp = vjp(jnp.asarray(ct))
        y, gx = np.asarray(y), np.asarray(gx)
        gk = np.asarray(gp["conv"]["kernel"])
        gb = np.asarray(gp["conv"]["bias"]) if bias else None

    plain = torch.nn.Conv2d(cin, cout, k, s, p, d, g, bias, dtype=torch.float64)
    lowered = tresnest.lower_grouped_convs_(torch.nn.Sequential(plain), **{lowering: "all"})[0]
    assert type(lowered).__name__ == {"dense": "DenseGroupsConv2d",
                                      "einsum": "EinsumGroupsConv2d"}[lowering]
    with torch.no_grad():
        lowered.weight.copy_(torch.from_numpy(kern).permute(3, 2, 0, 1))
        if bias:
            lowered.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    yt = lowered(xt)
    yt.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lowered.weight.grad.permute(2, 3, 1, 0).numpy(), gk, rtol=0,
                               atol=1e-12)
    if bias:
        np.testing.assert_allclose(lowered.bias.grad.numpy(), gb, rtol=0, atol=1e-12)


# -- the lowered Predictors ---------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """The golden fill as JAX variables and the port's state dict, and
    request images (64², B = 2, float32 in [0, 1])."""
    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    images = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return variables, from_jax_variables(variables), images


@pytest.mark.parametrize("kw", [{"einsum_groups": "decoder+enc"}, {"dense_groups": "decoder"}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_lowered_predictor_matches_jax(served, kw):
    variables, sd, images = served
    want = JaxPredictor(variables, dtype=jnp.float32, use_fused_decoder=True, **kw)(images)
    pred = Predictor(sd, dtype=torch.float32, device="cpu", **kw)
    lowered = [n for n, m in pred.model.named_modules()
               if isinstance(m, (tresnest.DenseGroupsConv2d, tresnest.EinsumGroupsConv2d))]
    assert len(lowered) == {"einsum_groups": 31, "dense_groups": 15}[next(iter(kw))]
    np.testing.assert_allclose(pred(images), want, atol=1e-5, rtol=0)


def test_predictor_specs_raise_before_any_build():
    for kw in ({"dense_groups": "bogus"}, {"einsum_groups": "decoder:"}):
        with pytest.raises(ValueError, match="dense_groups"):
            Predictor({}, device="cpu", **kw)


@pytest.fixture(scope="module")
def batch():
    trainer = ttrainer.Trainer(_cfg(), device="cpu")
    return trainer.device_batch(next(ds.batch_iterator(ttrainer.build_dataset(trainer.cfg),
                                                       2, seed=0)))


# -- the bf16 Adam moment ------------------------------------------------------------
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_bf16_moment_matches_optax(weight_decay, grad_clip):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    params = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (3.0 if i % 2 else 0.05)
              for s in shapes] for i in range(5)]
    sched = jsched.polynomial_decay(1e-2, 1e-6, 10, 0.9)
    tx = jsched.make_optimizer(schedule=sched, weight_decay=weight_decay, grad_clip=grad_clip,
                               moment_dtype="bfloat16")
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tsched.make_optimizer(tp, schedule=tsched.polynomial_decay(1e-2, 1e-6, 10, 0.9),
                                weight_decay=weight_decay, grad_clip=grad_clip,
                                moment_dtype="bfloat16")
    for step_grads in grads:
        updates, js = tx.update([jnp.asarray(g) for g in step_grads], js, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    adam = [s for s in jax.tree.leaves(js, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")][0]
    for p, jparam, mu, nu in zip(tp, jp, adam.mu, adam.nu):
        st = opt.opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        got = st["exp_avg"].view(torch.int16).numpy().astype(np.int32)
        want = np.asarray(mu).view(np.int16).astype(np.int32)
        assert np.abs(got - want).max() <= 1
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(nu), rtol=1e-6, atol=0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparam), rtol=1e-6, atol=1e-9)


def _host_moment_adam(params, grads, lrs, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """MomentAdam as it formed its bias corrections and -lr on the host (numpy
    float32 pow), before they moved to the device: the updated params and
    (exp_avg, exp_avg_sq) per parameter."""
    f32 = np.float32
    mus = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    params = [p.clone() for p in params]
    b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16))
    for t, (step_grads, lr) in enumerate(zip(grads, lrs), start=1):
        mu = torch._foreach_mul(step_grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
        torch._foreach_copy_(mus, mu)
        g2 = torch._foreach_mul(step_grads, step_grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)
        torch._foreach_div_(mu, float(f32(1) - f32(b1) ** f32(t)))
        denom = torch._foreach_div(nus, float(f32(1) - f32(b2) ** f32(t)))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(mu, denom)
        if weight_decay > 0:
            torch._foreach_add_(mu, torch._foreach_mul(params, weight_decay))
        torch._foreach_mul_(mu, float(f32(-lr)))
        torch._foreach_add_(params, mu)
    return params, list(zip(mus, nus))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("device_lr", [False, True], ids=["float-lr", "tensor-lr"])
def test_bf16_moment_equals_its_host_arithmetic(weight_decay, device_lr):
    """MomentAdam with its update count and bias corrections on the
    parameters' device (and, as on CUDA, its rate from a one-element tensor)
    equals its former host arithmetic: the moments bit for bit (the bias
    corrections do not enter them), the parameters within 1e-6 relative
    (numpy's and torch's float32 pow may differ in the last bit), as
    test_bf16_moment_matches_optax holds them to optax."""
    rng = np.random.default_rng(5)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    init = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [[torch.from_numpy((rng.standard_normal(s) * (3.0 if i % 2 else 0.05))
                               .astype(np.float32)) for s in shapes] for i in range(5)]
    sched = tsched.polynomial_decay(1e-2, 1e-6, 10, 0.9)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = tsched.make_optimizer(tp, schedule=sched, weight_decay=weight_decay,
                                moment_dtype="bfloat16")
    if device_lr:
        opt.lrs = torch.zeros(1)  # the CPU stands in for the device
    for step_grads in grads:
        for p, g in zip(tp, step_grads):
            p.grad = g.clone()
        opt.step()
    want, moments = _host_moment_adam([torch.from_numpy(p) for p in init], grads,
                                      [sched(i) for i in range(5)], weight_decay=weight_decay)
    for p, w, (mu, nu) in zip(tp, want, moments):
        st = opt.opt.state[p]
        assert float(st["step"]) == 5 and st["step"].device == p.device
        assert torch.equal(st["exp_avg"], mu) and torch.equal(st["exp_avg_sq"], nu)
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-9)


def test_moment_dtype_values():
    p = torch.nn.Parameter(torch.zeros(2))
    assert isinstance(tsched.make_optimizer([p], moment_dtype="float32").opt, torch.optim.Adam)
    assert isinstance(tsched.make_optimizer([p], moment_dtype="bfloat16").opt, tsched.MomentAdam)
    with pytest.raises(ValueError, match="moment_dtype"):
        ttrainer.Trainer(_cfg(**{"optim.moment_dtype": "float16"}), device="cpu")


def test_bf16_moment_checkpoint_round_trip(batch):
    """state -> checkpoint dict -> a fresh state: exp_avg stays bf16 and the
    step after the round trip equals the step without it."""
    trainer = ttrainer.Trainer(_cfg(**{"optim.moment_dtype": "bfloat16",
                                       "optim.grad_clip": 1.0}), device="cpu")
    live, fresh = trainer.init_state(), trainer.init_state()
    trainer.train_step(live, batch)
    saved = tckpt._to_host(tckpt.state_to_dict(live))
    assert saved["seg_opt"]["opt"]["state"][0]["exp_avg"].dtype == torch.bfloat16
    tckpt.load_state_dict_into(fresh, saved)
    for opt in (fresh.seg_opt, fresh.critic_opt):
        assert isinstance(opt.opt, tsched.MomentAdam)
        assert all(s["exp_avg"].dtype == torch.bfloat16 and s["exp_avg_sq"].dtype == torch.float32
                   for s in opt.opt.state.values())
    a, b = trainer.train_step(live, batch), trainer.train_step(fresh, batch)
    assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    for player in ("segmentor", "critic"):
        for x, y in zip(getattr(live, player).state_dict().values(),
                        getattr(fresh, player).state_dict().values()):
            assert torch.equal(x, y)
    for opt in ("seg_opt", "critic_opt"):
        for x, y in zip(getattr(live, opt).opt.state.values(),
                        getattr(fresh, opt).opt.state.values()):
            assert all(torch.equal(x[k], y[k]) for k in x)


# -- the switches through the Trainer -------------------------------------------------
@pytest.mark.parametrize("override,match", [
    ({"train.remat": "block:05"}, "decoder indices"),
    ({"train.remat": "block:012e05"}, "encoder layers"),
    ({"train.remat": "blockx"}, "unknown remat mode"),
    ({"train.remat": "bogus"}, "unknown remat mode"),
    ({"train.dense_groups": "bogus"}, "dense_groups"),
    ({"train.einsum_groups": "decoder:x1"}, "dense_groups"),
])
def test_bad_specs_raise(override, match):
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(_cfg(**override), device="cpu")


def test_step_lowers_the_segmentor_and_refuses_bad_specs(batch):
    with pytest.raises(ValueError, match="dense_groups"):
        make_train_step(StepConfig(use_discriminator=False, dense_groups="bogus"))
    with pytest.raises(ValueError, match="unknown remat mode"):
        make_train_step(StepConfig(use_discriminator=False, remat="bogus"))
    state = ttrainer.Trainer(_cfg(), device="cpu").init_state()
    step = make_train_step(StepConfig(use_discriminator=False, dense_groups="decoder:0",
                                      einsum_groups="enc"))
    step(state, batch)
    kinds = [type(m).__name__ for m in state.segmentor.modules()]
    assert kinds.count("DenseGroupsConv2d") == 3 and kinds.count("EinsumGroupsConv2d") == 16


def test_init_state_wires_every_switch():
    trainer = ttrainer.Trainer(_cfg(**{"train.remat": "block:01e34+conv",
                                       "train.dense_groups": "decoder:01",
                                       "train.einsum_groups": "decoder:1+enc",
                                       "optim.moment_dtype": "bfloat16"}), device="cpu")
    state = trainer.init_state()
    seg = state.segmentor
    assert [seg.get_submodule(f"decoder_{d}").remat for d in range(5)] == \
        ["conv", "conv", False, False, False]
    assert [seg.get_submodule(f"encoder_{li}")[0].remat for li in range(1, 5)] == \
        [False, False, "conv", "conv"]
    assert type(seg.get_submodule("decoder_0.conv.3.conv")).__name__ == "DenseGroupsConv2d"
    assert type(seg.get_submodule("decoder_1.conv.3.fc2")).__name__ == "EinsumGroupsConv2d"
    assert type(seg.get_submodule("encoder_4.2.conv2.conv")).__name__ == "EinsumGroupsConv2d"
    assert type(seg.get_submodule("decoder_2.conv.3.conv")) is torch.nn.Conv2d
    assert isinstance(state.seg_opt.opt, tsched.MomentAdam)
    assert isinstance(state.critic_opt.opt, tsched.MomentAdam)
    assert trainer.train_step.__name__ == "train_step"
