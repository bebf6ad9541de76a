"""One whole adversarial train step of the port against the JAX package's,
plus its optimizer, schedule and data path, on the CPU.

The step: ResnestUNet at 64², B = 2, the critic at depth 4 with
num_filters = 8 and both noise layers off (JAX's threefry draws cannot be
reproduced), from one JAX `init` of both modules carried to the port by the
weight bridge, on one synthetic batch that both sides take as the same
arrays. The JAX step is jitted once and run once, in float64, with an
optimizer that stores the gradients it is given as its state and leaves the
parameters be; the port's gradients are read from `.grad` after its step.

Why float64 and 64². The step is badly conditioned in float32: batch norms
normalise few values per channel (the split-attention BNs B = 2 pooled
values, layer 4 at 32² only B x 1 x 1), and float32 rounding grows through
them, the more so in the JAX package's E[x²] - E[x]² variance. At 32² the
two packages part visibly even in float64; at 64² float64 agrees to
rounding. No float32 pair meets a per-tensor 1e-3 on the segmentor's
gradient, so the float64 case is the exact check (losses 1e-7 relative, as
the JAX step takes its GAN losses on float32 logits; gradients 1e-6 of each
tensor's largest entry), and the float32 case bounds the float32 port
(losses 1e-3 relative; whole-gradient relative L2 0.25 for the segmentor,
1e-3 for the critic; BN stats and u/v as set below).

The optimizer update is checked on its own, against optax on fixed
gradients, to 1e-6: a first Adam step is about lr * sign(g), so parameters
after a whole step say little (tests/test_train_step.py:114-123).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from octave_tpu.data import datasets as jds
from octave_tpu.data import preprocess as jpre
from octave_tpu.models.discriminator import DiscriminatorBlock as JaxD
from octave_tpu.models.segmentor import ResnestUNet as JaxUNet
from octave_tpu.train import schedule as jsched
from octave_tpu.train.state import TrainState as JaxState
from octave_tpu.train.steps import StepConfig as JaxStepConfig
from octave_tpu.train.steps import make_train_step as jax_make_train_step
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.data import preprocess as tpre
from octave_tpu_torch.models.discriminator import DiscriminatorBlock
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.train import schedule as tsched
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.train.steps import StepConfig, make_train_step
from octave_tpu_torch.utils.convert import (
    from_jax_discriminator,
    from_jax_variables,
    load_reference_state_dict,
)

HW, B, NF, DEPTH = 64, 2, 8, 4
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
# losses: rtol of the port's step against the float64 JAX step; the JAX step
# takes the GAN losses on float32 casts of the critic's logits, hence 1e-7
LOSS_RTOL = {torch.float64: 1e-7, torch.float32: 1e-3}
# gradients in float64: atol as a share of each tensor's largest entry, with
# a floor as a share of the player's largest entry for the biases that feed a
# batch norm (their exact gradient is 0; both sides leave rounding there)
GRAD_RTOL_F64, GRAD_FLOOR_F64 = 1e-6, 1e-9
# gradients in float32: relative L2 error of each player's whole gradient
GRAD_L2_F32 = {"segmentor": 0.25, "critic": 1e-3}
# BN running stats (rtol, atol): the JAX BN's E[x^2] - E[x]^2 variance is
# itself ~1e-8 relative off in float64; in float32 layer 4 normalises 8
# values per channel and its stats land up to a few 1e-3 from float64
BN_TOL = {torch.float64: (1e-6, 1e-9), torch.float32: (1e-2, 1e-3)}


def _grad_store():
    """An optax transformation whose state is the last gradient it saw and
    whose update is zero: one step of it exposes the step's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def _batch():
    """One synthetic batch through the port's data path, as numpy; both
    steps take these very arrays (the data paths are compared on their own:
    XLA's uint8 -> [0, 1] scaling can round an image value 1 ulp away)."""
    host = next(tds.batch_iterator(tds.SyntheticOcta((HW, HW), n=4, seed=5), B, seed=2))
    batch = tpre.prepare_batch(host["image"], host["scribble"], host["mask"], size=(HW, HW),
                               num_classes=2, depth=DEPTH, in_channels=3, device="cpu")
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy()
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_step_result():
    """(initial variables, and the float64 JAX step's gradients, new BN
    stats, new spectral u/v and losses)."""
    seg = JaxUNet(num_classes=2)
    disc = JaxD(input_hw=(HW, HW), depth=DEPTH, num_filters=NF, instance_noise=False,
                label_noise=False)
    k_seg, k_disc = jax.random.split(jax.random.PRNGKey(0))
    seg_vars = jax.jit(lambda k: seg.init(k, jnp.zeros((1, HW, HW, 3)), False))(k_seg)
    pyr0 = [jnp.zeros((1, HW // 2**i, HW // 2**i, 2)) for i in range(DEPTH + 1)]
    disc_vars = jax.jit(lambda k: disc.init({"params": k, "noise": k}, pyr0, False))(k_disc)
    seg_vars, disc_vars = (jax.tree.map(np.asarray, v) for v in (seg_vars, disc_vars))
    with jax.enable_x64():
        f64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        batch = _batch()
        sv, dv = f64(seg_vars), f64(disc_vars)
        state = JaxState.create(seg_params=sv["params"], disc_params=dv["params"],
                                batch_stats=sv["batch_stats"], spectral=dv["spectral"],
                                seg_tx=_grad_store(), disc_tx=_grad_store())
        new_state, losses = jax.jit(jax_make_train_step(seg, disc, JaxStepConfig()))(
            state, f64(batch))
        out = jax.tree.map(np.asarray, (new_state.seg_opt_state, new_state.disc_opt_state,
                                        new_state.batch_stats, new_state.spectral, losses))
    assert out[0]["fc"]["conv"]["kernel"].dtype == np.float64
    return seg_vars, disc_vars, out


@functools.lru_cache(maxsize=None)
def _port_step_result(dtype):
    """The port's step in `dtype` from the same weights and batch."""
    seg_vars, disc_vars, _ = _jax_step_result()
    seg = ResnestUNet(2)
    load_reference_state_dict(seg, from_jax_variables(seg_vars))
    critic = DiscriminatorBlock((HW, HW), depth=DEPTH, num_filters=NF, instance_noise=False,
                                label_noise=False)
    critic.load_state_dict(from_jax_discriminator(disc_vars, instance_noise=False))
    seg, critic = (m.to(dtype, memory_format=torch.channels_last) for m in (seg, critic))
    state = TrainState(segmentor=seg, seg_opt=tsched.make_optimizer(seg.parameters()),
                       critic=critic, critic_opt=tsched.make_optimizer(critic.parameters()),
                       generator=torch.Generator().manual_seed(0))
    batch = {k: tuple(torch.from_numpy(a).to(dtype) for a in v) if isinstance(v, tuple)
             else torch.from_numpy(v).to(dtype) for k, v in _batch().items()}
    losses = make_train_step(StepConfig())(state, batch)
    return state, {k: v.item() for k, v in losses.items()}


@DTYPES
def test_losses_match_jax(dtype):
    want = _jax_step_result()[2][4]
    state, got = _port_step_result(dtype)
    assert list(got) == ["loss_sup", "loss_ild", "loss_adv", "loss_seg_total", "loss_disc"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL[dtype], err_msg=k)
    assert state.step == 1


@DTYPES
@pytest.mark.parametrize("player", ["segmentor", "critic"])
def test_gradients_match_jax(player, dtype):
    seg_vars, disc_vars, (seg_g, disc_g, _, spectral, _) = _jax_step_result()
    state, _ = _port_step_result(dtype)
    if player == "segmentor":
        module = state.segmentor
        want = from_jax_variables({"params": seg_g, "batch_stats": seg_vars["batch_stats"]})
    else:
        module = state.critic
        want = from_jax_discriminator({"params": disc_g, "spectral": spectral},
                                      instance_noise=False)
    params = dict(module.named_parameters())
    assert len(params) > (300 if player == "segmentor" else 10)
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == dtype, name
    got = {n: p.grad.double().numpy() for n, p in params.items()}
    want = {n: want[n].numpy() for n in params}
    if dtype == torch.float64:
        floor = GRAD_FLOOR_F64 * max(float(np.abs(g).max()) for g in want.values())
        for n, g in want.items():
            atol = max(GRAD_RTOL_F64 * float(np.abs(g).max()), floor)
            np.testing.assert_allclose(got[n], g, rtol=0, atol=atol, err_msg=n)
    else:
        err = np.sqrt(sum(float(((got[n] - g) ** 2).sum()) for n, g in want.items()))
        norm = np.sqrt(sum(float((g**2).sum()) for g in want.values()))
        assert err / norm < GRAD_L2_F32[player], (player, err / norm)


@DTYPES
def test_bn_stats_and_spectral_state_match_jax(dtype):
    """BN running stats move once (the segmentor forward); u/v twice (D(fake)
    then D(real)) from the step's original vectors."""
    seg_vars, disc_vars, (_, _, stats, spectral, _) = _jax_step_result()
    state, _ = _port_step_result(dtype)
    rtol, atol = BN_TOL[dtype]
    want_bn = from_jax_variables({"params": seg_vars["params"], "batch_stats": stats})
    before_bn = from_jax_variables(seg_vars)
    n = 0
    for name, buf in state.segmentor.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert not torch.equal(buf.float(), before_bn[name]), name
            np.testing.assert_allclose(buf.double().numpy(), want_bn[name].numpy(), rtol=rtol,
                                       atol=atol, err_msg=name)
            n += 1
    assert n > 150
    want_uv = from_jax_discriminator({"params": disc_vars["params"], "spectral": spectral},
                                     instance_noise=False)
    for name, buf in state.critic.named_buffers():
        np.testing.assert_allclose(buf.double().numpy(), want_uv[name].numpy(),
                                   atol=1e-12 if dtype == torch.float64 else 1e-5, err_msg=name)


# --- optimizer and schedule ------------------------------------------------

@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (1e-2, None), (0.0, 0.05),
                                               (1e-2, 1e3)],
                         ids=["adam", "adamw", "adam-clipped", "adamw-clip-idle"])
def test_optimizer_matches_optax(weight_decay, clip):
    """Three updates on fixed gradients along a schedule that reaches its end."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (1.0, 0.1, 3.0)]
    tx = jsched.make_optimizer(schedule=jsched.polynomial_decay(1e-2, 1e-4, 2, 0.9),
                               weight_decay=weight_decay, grad_clip=clip)
    opt_state, want = tx.init(params), params
    for g in grads:
        upd, opt_state = tx.update(g, opt_state, want)
        want = optax.apply_updates(want, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tsched.make_optimizer(tp.values(), schedule=tsched.polynomial_decay(1e-2, 1e-4, 2, 0.9),
                                weight_decay=weight_decay, grad_clip=clip)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in tp.items():
        assert not np.allclose(p.detach().numpy(), params[k])
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,))]
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tsched.clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((g**2).sum() for g in grads)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_schedule_matches_optax():
    want = jsched.polynomial_decay(1e-3, 1e-6, 10, 0.9)
    got = tsched.polynomial_decay(1e-3, 1e-6, 10, 0.9)
    for step in (0, 1, 2, 5, 9, 10, 11, 50):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = tsched.make_optimizer([p], schedule=got)
    lrs = []
    for _ in range(3):  # the first update runs at init_lr
        lrs.append(opt.opt.param_groups[0]["lr"])
        p.grad = torch.ones(2)
        opt.step()
    np.testing.assert_allclose(lrs, [got(0), got(1), got(2)], rtol=1e-12)
    with pytest.raises(ValueError, match="moment_dtype"):
        tsched.make_optimizer([p], moment_dtype="float16")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_device_learning_rates_follow_lambdalr(k):
    """On CUDA an update reads its rate from the optimizer's `lrs` tensor,
    loaded before each call of k updates (`load_lrs`): the table equals
    LambdaLR's sequence over the calls (the schedule at each update's count
    before the update), each update reads its own entry in float32, an
    update no call loaded loads its own rate, and `advance` counts a
    replayed call's updates as LambdaLR does. A CPU tensor stands in for the
    device's here."""
    sched = tsched.polynomial_decay(1e-2, 1e-4, 6, 0.9)
    p, q = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(2))
    plain = tsched.make_optimizer([p], schedule=sched)
    dev = tsched.make_optimizer([q], schedule=sched)
    assert plain.lrs is None
    dev.lrs = torch.zeros(1)
    read = []
    dev.opt.register_step_pre_hook(
        lambda opt, args, kwargs: read.append(float(opt.param_groups[0]["lr"])))
    for call in range(3):
        table = dev.lr_table(k)
        dev.load_lrs(k)
        assert dev.lrs.numel() >= k
        for _ in range(k):
            assert plain.opt.param_groups[0]["lr"] == table[len(read) - call * k]
            p.grad, q.grad = torch.ones(2), torch.ones(2)
            plain.step()
            dev.step()
        assert read[-k:] == [float(np.float32(lr)) for lr in table]
        assert isinstance(dev.opt.param_groups[0]["lr"], float)  # the tensor only in the update
    p.grad, q.grad = torch.ones(2), torch.ones(2)
    want = plain.opt.param_groups[0]["lr"]
    plain.step()
    dev.step()  # no call loaded it
    assert read[-1] == float(np.float32(want)) == float(np.float32(sched(3 * k)))
    plain.sched.step()
    plain.sched.step()
    dev.advance(2)
    assert dev.sched.last_epoch == plain.sched.last_epoch == 3 * k + 3
    assert dev.opt.param_groups[0]["lr"] == plain.opt.param_groups[0]["lr"] == sched(3 * k + 3)


def test_device_path_zeroes_gradients_in_place():
    """With `lrs` (CUDA) zero_grad keeps each gradient tensor and zeroes it,
    so a captured step writes the same tensors every replay; on the CPU it
    drops them. Both train alike."""
    rng = np.random.default_rng(2)
    init = rng.standard_normal((3, 4)).astype(np.float32)
    p, q = (torch.nn.Parameter(torch.from_numpy(init.copy())) for _ in range(2))
    plain, dev = (tsched.make_optimizer([t], schedule=tsched.polynomial_decay(1e-2, 1e-4, 4, 0.9),
                                        grad_clip=1.0) for t in (p, q))
    dev.lrs = torch.zeros(1)
    for i in range(3):
        g = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
        for opt, t in ((plain, p), (dev, q)):
            opt.zero_grad()
            (t * g).sum().backward()
        kept = q.grad
        plain.step()
        dev.step()
        dev.zero_grad()
        plain.zero_grad()
        assert q.grad is kept and not kept.any() and p.grad is None
    np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=1e-6, atol=1e-7)


# --- data path ---------------------------------------------------------------

@pytest.mark.parametrize("size", [(32, 32), (40, 24)])
def test_synthetic_and_batches_byte_identical(size):
    jset, tset = jds.SyntheticOcta(size, n=6, seed=3), tds.SyntheticOcta(size, n=6, seed=3)
    for i in range(len(jset)):
        for field in ("image", "scribble", "mask"):
            a, b = getattr(jset[i], field), getattr(tset[i], field)
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), (i, field)
    for kw in (dict(seed=1), dict(shuffle=False, epochs=1, drop_last=False)):
        jit, tit = jds.batch_iterator(jset, 4, **kw), tds.batch_iterator(tset, 4, **kw)
        for _ in range(3 if "seed" in kw else 2):
            a, b = next(jit), next(tit)
            assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="never yield"):
        next(tds.batch_iterator(tset, 8))


@pytest.mark.parametrize("src,size", [((32, 32), (32, 32)), ((24, 24), (32, 32)),
                                      ((48, 40), (32, 32))], ids=["same", "up", "down"])
def test_prepare_batch_matches_jax(src, size):
    """Upscale and downscale included: jax.image.resize antialiases when it
    shrinks, as the port's F.interpolate(antialias=True)."""
    host = next(tds.batch_iterator(tds.SyntheticOcta(src, n=2, seed=7), 2))
    want = jpre.prepare_batch(*(jnp.asarray(host[k]) for k in ("image", "scribble", "mask")),
                              size=size, num_classes=2, depth=3, in_channels=3)
    got = tpre.prepare_batch(host["image"], host["scribble"], host["mask"], size=size,
                             num_classes=2, depth=3, in_channels=3, device="cpu")
    assert got["image"].shape == (2, *size, 3) and got["image"].is_contiguous()
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=2e-6)
    for k in ("scribble_onehot", "mask_onehot"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert len(got["mask_pyramid"]) == 4
    for a, b in zip(got["mask_pyramid"], want["mask_pyramid"]):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_avg_pyramid_and_onehots_match_jax():
    rng = np.random.default_rng(4)
    mask = rng.integers(0, 2, (2, 16, 16))
    dense = jpre.mask_to_onehot(jnp.asarray(mask), 2)
    for a, b in zip(tpre.mask_pyramid(torch.from_numpy(np.array(dense)), 3, "avg"),
                    jpre.mask_pyramid(dense, 3, "avg")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    scrib = rng.integers(0, 3, (2, 5, 5)).astype(np.uint8)
    assert np.array_equal(tpre.scribble_to_onehot(torch.from_numpy(scrib), 2).numpy(),
                          np.asarray(jpre.scribble_to_onehot(jnp.asarray(scrib), 2)))
    with pytest.raises(ValueError, match="pyramid method"):
        tpre.mask_pyramid(torch.zeros(1, 4, 4, 2), 1, "max")
