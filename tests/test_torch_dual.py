"""The dual-decoder train path of the port against the JAX package's, on the
CPU: one parallel_head_gate step with its two critics, the per-head targets
of `rose(dual=True)` and `prepare_batch(scribble_c=...)`, and the Trainer,
checkpoints and command line on the family's architectures.

The step: ResnestUnetParallelHeadAttentionGate at 64², B = 2, gating level 4
(seven gates), the "main" critic at depth 4 and the "c" critic at depth 1,
num_filters 8, both noise layers off, from one JAX `init` of the three
modules carried over by the weight bridge, on one batch that both sides take
as the same arrays, with distinct head-1 scribbles. The JAX step runs once,
jitted, in float64, with optimizers that store their gradients as their
state (as tests/test_torch_train.py does for `unet`); the bounds are that
file's float64 bounds.
"""
import functools
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from test_torch_datasets import _build_rose
from test_torch_train import BN_TOL, GRAD_FLOOR_F64, GRAD_RTOL_F64, LOSS_RTOL, _grad_store
from octave_tpu.data import datasets as jds
from octave_tpu.data import preprocess as jpre
from octave_tpu.models.discriminator import DiscriminatorBlock as JaxD
from octave_tpu.models.segmentor import ResnestUnetParallelHeadAttentionGate as JaxPHG
from octave_tpu.train.state import TrainState as JaxState
from octave_tpu.train.steps import StepConfig as JaxStepConfig
from octave_tpu.train.steps import make_train_step as jax_make_train_step
from octave_tpu_torch.data import augment as taug
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.data import preprocess as tpre
from octave_tpu_torch.models.discriminator import DiscriminatorBlock
from octave_tpu_torch.models.segmentor import ResnestUnetParallelHeadAttentionGate
from octave_tpu_torch.train import schedule as tsched
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.train.steps import StepConfig, make_train_step
from octave_tpu_torch.train.trainer import Trainer
from octave_tpu_torch.utils import checkpoint as tckpt
from octave_tpu_torch.utils.config import Config
from octave_tpu_torch.utils.convert import (
    from_jax_critics,
    from_jax_variables,
    load_reference_state_dict,
)

HW, B, NF = 64, 2, 8
DEPTHS = {"main": 4, "c": 1}


@functools.lru_cache(maxsize=None)
def _batch():
    """One synthetic batch with head-1 scribbles of other phantoms, through
    the port's data path, as numpy."""
    host = next(tds.batch_iterator(tds.SyntheticOcta((HW, HW), n=4, seed=5), B, seed=2))
    other = next(tds.batch_iterator(tds.SyntheticOcta((HW, HW), n=4, seed=6), B, seed=2))
    batch = tpre.prepare_batch(host["image"], host["scribble"], host["mask"], size=(HW, HW),
                               depth=4, scribble_c=other["scribble"], device="cpu")
    assert not torch.equal(batch["scribble_onehot"], batch["scribble_onehot_c"])
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.numpy()
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_step_result():
    seg = JaxPHG(num_classes=2, gating_level=4)
    discs = {n: JaxD(input_hw=(HW, HW), depth=d, num_filters=NF, instance_noise=False,
                     label_noise=False) for n, d in DEPTHS.items()}
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    seg_vars = jax.jit(lambda k: seg.init(k, jnp.zeros((1, HW, HW, 3)), False))(keys[0])
    disc_vars = {}
    for (name, d), k in zip(discs.items(), keys[1:]):
        pyr = [jnp.zeros((1, HW // 2**i, HW // 2**i, 2)) for i in range(DEPTHS[name] + 1)]
        disc_vars[name] = jax.jit(lambda k, d=d, pyr=pyr: d.init({"params": k, "noise": k},
                                                                 pyr, False))(k)
    seg_vars, disc_vars = (jax.tree.map(np.asarray, v) for v in (seg_vars, disc_vars))
    with jax.enable_x64():
        f64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        sv = f64(seg_vars)
        dv = {n: f64(v) for n, v in disc_vars.items()}
        state = JaxState.create(
            seg_params=sv["params"], batch_stats=sv["batch_stats"],
            disc_params={n: v["params"] for n, v in dv.items()},
            spectral={n: v["spectral"] for n, v in dv.items()},
            seg_tx=_grad_store(), disc_tx=_grad_store())
        cfg = JaxStepConfig(discriminator_depth=DEPTHS["main"], discriminator_depth_c=DEPTHS["c"])
        new_state, losses = jax.jit(jax_make_train_step(seg, discs, cfg))(state, f64(_batch()))
        out = jax.tree.map(np.asarray, (new_state.seg_opt_state, new_state.disc_opt_state,
                                        new_state.batch_stats, new_state.spectral, losses))
    return seg_vars, disc_vars, out


@functools.lru_cache(maxsize=None)
def _port_step_result():
    seg_vars, disc_vars, _ = _jax_step_result()
    seg = ResnestUnetParallelHeadAttentionGate(2, gating_level=4)
    load_reference_state_dict(seg, from_jax_variables(seg_vars))
    critic = nn.ModuleDict({n: DiscriminatorBlock((HW, HW), depth=d, num_filters=NF,
                                                  instance_noise=False, label_noise=False)
                            for n, d in DEPTHS.items()})
    critic.load_state_dict(from_jax_critics({n: v["params"] for n, v in disc_vars.items()},
                                            {n: v["spectral"] for n, v in disc_vars.items()},
                                            instance_noise=False))
    seg, critic = (m.to(torch.float64, memory_format=torch.channels_last)
                   for m in (seg, critic))
    state = TrainState(segmentor=seg, seg_opt=tsched.make_optimizer(seg.parameters()),
                       critic=critic, critic_opt=tsched.make_optimizer(critic.parameters()),
                       generator=torch.Generator().manual_seed(0))
    batch = {k: tuple(torch.from_numpy(a).double() for a in v) if isinstance(v, tuple)
             else torch.from_numpy(v).double() for k, v in _batch().items()}
    cfg = StepConfig(discriminator_depth=DEPTHS["main"], discriminator_depth_c=DEPTHS["c"])
    losses = make_train_step(cfg)(state, batch)
    return state, {k: v.item() for k, v in losses.items()}


def test_dual_step_losses_match_jax():
    want = _jax_step_result()[2][4]
    state, got = _port_step_result()
    assert list(got) == ["loss_sup", "loss_ild", "loss_adv", "loss_seg_total", "loss_disc"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL[torch.float64], err_msg=k)
    assert state.step == 1


@pytest.mark.parametrize("player", ["segmentor", "main", "c"])
def test_dual_step_gradients_match_jax(player):
    """float64: each tensor within 1e-6 of its largest entry (floor 1e-9 of
    the player's largest), the bounds of tests/test_torch_train.py."""
    seg_vars, _, (seg_g, disc_g, _, spectral, _) = _jax_step_result()
    state, _ = _port_step_result()
    if player == "segmentor":
        module = state.segmentor
        want = from_jax_variables({"params": seg_g, "batch_stats": seg_vars["batch_stats"]})
    else:
        module = state.critic[player]
        want = {k[len(player) + 1:]: v for k, v in from_jax_critics(
            disc_g, spectral, instance_noise=False).items() if k.startswith(player + ".")}
    params = dict(module.named_parameters())
    assert len(params) > {"segmentor": 300, "main": 10, "c": 4}[player]
    got = {n: p.grad.numpy() for n, p in params.items()}
    want = {n: want[n].numpy() for n in params}
    floor = GRAD_FLOOR_F64 * max(float(np.abs(g).max()) for g in want.values())
    for n, g in want.items():
        assert np.abs(g).max() > 0 or n.endswith("bias"), n
        atol = max(GRAD_RTOL_F64 * float(np.abs(g).max()), floor)
        np.testing.assert_allclose(got[n], g, rtol=0, atol=atol, err_msg=n)


def test_dual_step_bn_stats_and_spectral_match_jax():
    """BN running stats move once; each critic's u/v twice (D(fake), D(real))
    from the step's original vectors."""
    seg_vars, disc_vars, (_, _, stats, spectral, _) = _jax_step_result()
    state, _ = _port_step_result()
    rtol, atol = BN_TOL[torch.float64]
    want_bn = from_jax_variables({"params": seg_vars["params"], "batch_stats": stats})
    n = 0
    for name, buf in state.segmentor.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_bn[name].numpy(), rtol=rtol,
                                       atol=atol, err_msg=name)
            n += 1
    assert n > 150
    want_uv = from_jax_critics({k: v["params"] for k, v in disc_vars.items()}, spectral,
                               instance_noise=False)
    before = from_jax_critics({k: v["params"] for k, v in disc_vars.items()},
                              {k: v["spectral"] for k, v in disc_vars.items()},
                              instance_noise=False)
    for name, buf in state.critic.named_buffers():
        assert not np.allclose(buf.numpy(), before[name].numpy()), name
        np.testing.assert_allclose(buf.numpy(), want_uv[name].numpy(), atol=1e-12, err_msg=name)


# --- per-head targets --------------------------------------------------------

def test_rose_dual_batches_equal_jax(tmp_path):
    """rose(dual=True): head 0 takes thick_gt, head 1 (scribble_c) thin_gt;
    batches stack scribble_c only when every sample has one."""
    root = _build_rose(tmp_path, thick=True)
    for split in ("train", "test"):
        got, want = tds.rose(root, split=split, dual=True), jds.rose(root, split=split, dual=True)
        for i in range(len(want)):
            for f in ("image", "scribble", "mask", "scribble_c"):
                a, b = getattr(got[i], f), getattr(want[i], f)
                assert (a is None) == (b is None) == (split == "test" and f == "scribble_c"), f
                if a is not None:
                    assert a.dtype == b.dtype and np.array_equal(a, b), (split, i, f)
        a = next(tds.batch_iterator(got, 2, seed=3))
        b = next(jds.batch_iterator(want, 2, seed=3))
        assert set(a) == set(b) == ({"image", "scribble", "mask", "scribble_c"}
                                    if split == "train" else {"image", "scribble", "mask"})
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s = tds.rose(root, dual=True)[0]
    assert not np.array_equal(s.scribble, s.scribble_c)


@pytest.mark.parametrize("intensity", [0.0, 0.1])
def test_prepare_batch_scribble_c_equals_jax(rng, intensity):
    """scribble_c resizes with nearest and takes the very dihedral draws of
    the other labels (the JAX package's extra_labels)."""
    image = rng.integers(0, 256, (4, 20, 20), dtype=np.uint8)
    scrib, scrib_c = (rng.integers(0, 3, (4, 20, 20)).astype(np.uint8) for _ in range(2))
    mask = rng.integers(0, 2, (4, 20, 20)).astype(np.uint8)
    key = jax.random.PRNGKey(7)
    want = jpre.prepare_batch(*(jnp.asarray(a) for a in (image, scrib, mask)), size=(16, 16),
                              depth=2, augment_key=key, augment_intensity=intensity,
                              scribble_c=jnp.asarray(scrib_c))
    kg, ki = jax.random.split(key)
    bits = [torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (4,))))
            for k in jax.random.split(kg, 3)]
    jit = (None, None)
    if intensity:
        jit = [torch.from_numpy(np.array(jax.random.uniform(k, (4, 1, 1, 1), jnp.float32,
                                                            -intensity, intensity)))
               for k in jax.random.split(ki)]
    got = tpre.prepare_batch(image, scrib, mask, size=(16, 16), depth=2,
                             augment_draws=taug.Draws(*bits, *jit), scribble_c=scrib_c,
                             device="cpu")
    assert set(got) == set(want)
    for k in ("scribble_onehot", "scribble_onehot_c", "mask_onehot"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=1e-6)
    plain = tpre.prepare_batch(image, scrib, mask, size=(16, 16), depth=2, scribble_c=scrib_c,
                               device="cpu")
    assert not torch.equal(plain["scribble_onehot_c"], got["scribble_onehot_c"])
    assert "scribble_onehot_c" not in tpre.prepare_batch(image, scrib, mask, size=(16, 16),
                                                         depth=2, device="cpu")
    extra = taug.augment(taug.Draws(*bits), *(got[k] for k in ("image", "scribble_onehot",
                                                               "mask_onehot")),
                         extra_labels=(got["scribble_onehot_c"],))
    assert len(extra) == 4


# --- Trainer, checkpoints, command line ----------------------------------------

def _cfg(root, **over):
    return Config.from_dict({
        "model": {"architecture": "parallel_head_gate", "num_filters": 8},
        "data": {"dataset": "rose", "root": root, "image_size": (32, 32), "batch_size": 2,
                 "augment": True, "augment_intensity": 0.1},
        "train": {"steps": 1, "eval_every": 0, "log_every": 0, **over},
    })


def test_trainer_dual_critics_through_rose(tmp_path, caplog):
    """Two critics (main clamped to the 32² pyramid, c at depth 1), the
    per-head ROSE targets, one augmented step moving every kind of state,
    evaluation on head 0, and an exact checkpoint round trip."""
    root = _build_rose(tmp_path, thick=True)
    with caplog.at_level(logging.INFO, logger="octave_tpu_torch"):
        tr = Trainer(_cfg(root, checkpoint_dir=str(tmp_path / "ckpt")), device="cpu")
    assert tr.disc_depths == {"main": 4, "c": 1}
    state = tr.init_state()
    assert isinstance(state.critic, nn.ModuleDict) and list(state.critic) == ["main", "c"]
    assert [c.depth for c in state.critic.values()] == [4, 1]
    before = {k: v.clone() for k, v in tckpt.state_to_dict(state)["critic"].items()}
    seg0 = {k: v.clone() for k, v in state.segmentor.state_dict().items()}
    state = tr.fit(state)
    assert state.step == 1
    after = state.critic.state_dict()
    for name in ("main", "c"):
        for leaf in ("out.0.weight", "spectral_dict.spectral_0.0.weight_u"):
            assert not torch.equal(before[f"{name}.{leaf}"], after[f"{name}.{leaf}"]), name
    seg1 = state.segmentor.state_dict()
    for k in ("fc.weight", "fc_c.weight", "aag_0_c.conv1.weight", "encoder_1.0.bn1.running_mean"):
        assert not torch.equal(seg0[k], seg1[k]), k
    moments = tckpt.state_to_dict(state)["critic_opt"]["opt"]["state"]
    assert len(moments) == len(list(state.critic.parameters()))
    restored = tckpt.CheckpointManager(str(tmp_path / "ckpt")).restore_latest(tr.init_state())
    from test_torch_checkpoint import _assert_states_equal
    assert _assert_states_equal(restored, state) > 1500
    m = tr.evaluate(state)
    assert all(0.0 <= v <= 1.0 for v in m.values())
    shutil.rmtree(tmp_path / "ckpt")


def test_trainer_parallel_head_and_encoder_gating(tmp_path, caplog):
    """parallel_head has no pyramid: no critic, with the log line, and both
    heads supervised; ResnestUNet with encoder gating steps with its critic."""
    root = _build_rose(tmp_path, thick=True)
    with caplog.at_level(logging.INFO, logger="octave_tpu_torch"):
        tr = Trainer(_cfg(root, steps=1).apply_overrides(
            {"model.architecture": "parallel_head"}), device="cpu")
    assert "emits no attention pyramid" in caplog.text
    assert tr.disc_depths == {} and not tr.step_cfg.use_discriminator
    state = tr.fit()
    assert state.critic is None and state.step == 1
    tr = Trainer(_cfg(root).apply_overrides({"model.architecture": "unet",
                                              "model.encoder_gating": "true"}), device="cpu")
    state = tr.init_state()
    assert any(k.startswith("encoder_4_gate.0.") for k in state.segmentor.state_dict())
    assert isinstance(state.critic, DiscriminatorBlock)
    losses = tr.train_step(state, tr.device_batch(next(tds.batch_iterator(
        tds.rose(root), 2, seed=0))))
    assert set(losses) == {"loss_sup", "loss_ild", "loss_adv", "loss_seg_total", "loss_disc"}
    assert all(torch.isfinite(v) for v in losses.values())


def test_cli_predict_refuses_other_architectures(tmp_path):
    from octave_tpu_torch import cli

    os.makedirs(tmp_path / "img")
    for over in ("model.architecture=parallel_head_gate", "model.encoder_gating=true"):
        with pytest.raises(SystemExit, match="ResnestUNet without encoder gating"):
            cli.main(["predict", "--images", str(tmp_path / "img"), "--out",
                      str(tmp_path / "out"), "--device", "cpu", over])


def test_supervise_attention0_adds_the_finest_gate():
    """StepConfig.supervise_attention0 adds the supervised loss of the finest
    attention map to loss_sup, as the JAX step does."""
    import dataclasses

    from octave_tpu_torch.losses.segmentor import weighted_partial_ce

    class Stub(nn.Module):
        """(attentions, agg_map, x_4) from one learnable scale."""

        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.tensor(0.7))

        def forward(self, x):
            logits = self.w * x[..., :2]
            return (torch.softmax(logits, -1), torch.softmax(logits[:, ::2, ::2], -1)), \
                logits, x

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    scrib = torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 8, 8))])
    batch = {"image": x, "scribble_onehot": scrib}
    base = StepConfig(use_discriminator=False, lambda_ild=0.0)
    losses = {}
    for on in (False, True):
        stub = Stub()
        state = TrainState(segmentor=stub, seg_opt=tsched.make_optimizer(stub.parameters()))
        losses[on] = make_train_step(dataclasses.replace(base, supervise_attention0=on))(
            state, batch)["loss_sup"]
    extra = weighted_partial_ce(torch.softmax(0.7 * x[..., :2], -1), scrib, 2, manual=True)
    torch.testing.assert_close(losses[True], losses[False] + extra, rtol=1e-6, atol=0)
