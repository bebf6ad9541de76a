"""Remat, steps_per_call and each memory switch through the port's trainer,
on the CPU (tests/test_torch_switches.py holds the switches' parts against
the JAX package).

  * Every remat mode takes the same train step as remat=False, bit for bit
    on the CPU (the recompute repeats the forward's arithmetic): losses,
    every gradient and parameter, every BN buffer, `num_batches_tracked`
    advanced by exactly 1; also with synchronised batch norm at world 1. The
    modes whose region holds the gates run the AAG again in the recompute
    (10 forwards a step, 5 otherwise), and the save-the-convs modes
    recompute no convolution.
  * steps_per_call=2 trains what steps_per_call=1 trains, bit for bit, with
    augmentation and noise on, across a checkpoint cadence no call ends on
    and a resume.
  * Each switch value the trainer tests used to refuse trains through
    `Trainer.fit`.
At 32², B = 2, on two PyTorch threads.
"""
import os
import shutil

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.models import resnest as tresnest
from octave_tpu_torch.ops.kernels import aag as taag
from octave_tpu_torch.ops.norm import synchronize_batch_norm
from octave_tpu_torch.train import trainer as ttrainer
from octave_tpu_torch.train.steps import make_multi_step
from octave_tpu_torch.utils import checkpoint as tckpt
from octave_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
SMALL = {"train.steps": "2", "data.image_size": "[32,32]", "data.synthetic_n": "4",
         "data.batch_size": "2", "train.eval_every": "0", "train.log_every": "0",
         "model.instance_noise": "false", "model.label_noise": "false"}


def _cfg(**extra):
    return Config.load(SMOKE).apply_overrides({**SMALL, **extra})


# -- remat: the step against remat=False ------------------------------------------
@pytest.fixture(scope="module")
def batch():
    trainer = ttrainer.Trainer(_cfg(), device="cpu")
    return trainer.device_batch(next(ds.batch_iterator(ttrainer.build_dataset(trainer.cfg),
                                                       2, seed=0)))


def _state(trainer, sync=False):
    """trainer.init_state(): the same tensors for every remat mode and
    lowering (the modules are built from train.seed, then lowered)."""
    state = trainer.init_state()
    synchronize_batch_norm(state.segmentor, sync)
    return state


def _counted_step(trainer, state, batch):
    """(losses, AAG forwards) of one step of `trainer`."""
    calls = []
    forward = taag._AAGFunction.forward

    def counted(ctx, *args):
        calls.append(1)
        return forward(ctx, *args)

    taag._AAGFunction.forward = staticmethod(counted)
    try:
        losses = trainer.train_step(state, batch)
    finally:
        taag._AAGFunction.forward = staticmethod(forward)
    return losses, len(calls)


@pytest.fixture(scope="module")
def plain_step(batch):
    out = {}
    for sync in (False, True):
        trainer = ttrainer.Trainer(_cfg(), device="cpu")
        state = _state(trainer, sync)
        losses, n = _counted_step(trainer, state, batch)
        out[sync] = (state, losses, n)
    return out


# AAG forwards per step: the regions over the whole forward run the gates
# again in the recompute; the block modes leave them out of every region
REMAT_MODES = {"true": 10, "conv": 10, "block": 5, "block-enc": 5, "block:012": 5,
               "block:01e34": 5, "block:012+conv": 5}


@pytest.mark.parametrize("mode,sync", [(m, False) for m in REMAT_MODES]
                         + [("block:012+conv", True), ("conv", True)])
def test_remat_step_equals_plain_step(batch, plain_step, mode, sync):
    want_state, want_losses, want_n = plain_step[sync]
    trainer = ttrainer.Trainer(_cfg(**{"train.remat": mode}), device="cpu")
    state = _state(trainer, sync)
    losses, n = _counted_step(trainer, state, batch)
    assert want_n == 5 and n == REMAT_MODES[mode]
    assert {k: float(v) for k, v in losses.items()} == \
        {k: float(v) for k, v in want_losses.items()}
    for player in ("segmentor", "critic"):
        got, want = getattr(state, player), getattr(want_state, player)
        for (name, p), q in zip(got.named_parameters(), want.parameters()):
            assert torch.equal(p.grad, q.grad), (player, name)
            assert torch.equal(p, q), (player, name)
        for (name, b), c in zip(got.named_buffers(), want.buffers()):
            assert torch.equal(b, c), (player, name)
    nbt = [b for n, b in state.segmentor.named_buffers() if n.endswith("num_batches_tracked")]
    assert len(nbt) == 91 and all(int(b) == 1 for b in nbt)


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,lowering", [(True, None), ("conv", None), ("conv", "einsum"),
                                           ("conv", "dense")])
def test_save_convs_recomputes_no_convolution(mode, lowering):
    """Under 'conv' every convolution's output is kept, also with the splat's
    grouped convs lowered: the backward runs no forward convolution. Under
    True it runs them all again."""
    torch.manual_seed(0)
    dec = tresnest.ResNestDecoder(16, 8).train()
    if lowering:
        tresnest.lower_grouped_convs_(dec, **{lowering: "all"})
    dec.remat = mode
    x = torch.randn(2, 16, 8, 8, requires_grad=True)
    loss = dec(x).square().sum()
    with _CountConvs() as counter:
        loss.backward()
    assert counter.n == (5 if mode is True else 0)



@pytest.mark.parametrize("mode", [True, "conv", "block", "block:012+conv"])
def test_remat_regions_draw_no_random_numbers(batch, mode):
    """`ops.remat.run` does not stash the RNG state (putting a CUDA
    generator's state back is refused inside a CUDA-graph capture), which is
    exact because no region draws: the segmentor's train forward and
    backward under each mode leave torch's generator where it was."""
    from octave_tpu_torch.ops import remat
    from octave_tpu_torch.train.steps import adapt_segmentor_output, step_remat

    trainer = ttrainer.Trainer(_cfg(**{"train.remat": str(mode).lower()}), device="cpu")
    seg = trainer.init_state().segmentor
    before = torch.get_rng_state()
    _, agg_maps = adapt_segmentor_output(remat.run(step_remat(mode), seg, batch["image"]))
    agg_maps[0].square().sum().backward()
    assert seg.encoder_1[0].conv1.weight.grad is not None
    assert torch.equal(torch.get_rng_state(), before)


# -- steps_per_call -------------------------------------------------------------------
def test_multi_step_averages_the_losses():
    seen = []

    def step(state, batch):
        seen.append((float(batch["image"]), [float(t) for t in batch["mask_pyramid"]]))
        return {"loss": batch["image"] * 2}

    batches = {"image": torch.tensor([1.0, 3.0]),
               "mask_pyramid": [torch.tensor([5.0, 6.0]), torch.tensor([7.0, 8.0])]}
    out = make_multi_step(step, 2)(None, batches)
    assert seen == [(1.0, [5.0, 7.0]), (3.0, [6.0, 8.0])] and float(out["loss"]) == 4.0
    assert make_multi_step(step, 1) is step


def test_steps_per_call_trains_what_single_steps_train(tmp_path, monkeypatch):
    """4 steps at k = 2 (two calls, augmentation and noise on) equal 4 steps
    at k = 1 bit for bit; the checkpoint cadence of 3, which no call ends
    on, is crossed by the call that ends at step 4 and saves there; a run
    resumed from that k = 2 checkpoint to step 6 equals 6 steps at k = 1."""
    over = {"data.augment": "true", "data.augment_intensity": "0.1",
            "model.instance_noise": "true", "model.label_noise": "true"}
    saves = []
    save = tckpt.CheckpointManager.save

    def recorded(self, step, state):
        written = save(self, step, state)
        saves.append((int(step), written))
        return written

    monkeypatch.setattr(tckpt.CheckpointManager, "save", recorded)
    ck = str(tmp_path / "k2")
    k2 = {**over, "train.steps_per_call": "2", "train.checkpoint_dir": ck,
          "train.checkpoint_every": "3"}
    try:
        single = ttrainer.Trainer(_cfg(**over, **{"train.steps": "4"}), device="cpu").fit()
        two = ttrainer.Trainer(_cfg(**k2, **{"train.steps": "4"}), device="cpu").fit()
        assert single.step == two.step == 4
        assert saves == [(4, True), (4, False)]  # the cadence's, then the final one
        _assert_same(two, single)
        del two
        single = ttrainer.Trainer(_cfg(**over, **{"train.steps": "6"}),
                                  device="cpu").fit(single)
        resumed = ttrainer.Trainer(_cfg(**k2, **{"train.steps": "6"}), device="cpu").fit()
        assert single.step == resumed.step == 6
        _assert_same(resumed, single)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_same(got, want):
    for player in ("segmentor", "critic"):
        for (name, x), y in zip(getattr(got, player).state_dict().items(),
                                getattr(want, player).state_dict().values()):
            assert torch.equal(x, y), (player, name)


MOVED = [{"train.remat": "block-enc"}, {"train.remat": "block:012"},
         {"optim.moment_dtype": "bfloat16"}, {"optim.moment_dtype": "float32"},
         {"train.remat": "block"}, {"train.dense_groups": "decoder"},
         {"train.einsum_groups": "decoder"}, {"train.steps_per_call": "2"},
         {"train.remat": "conv"}, {"train.dense_groups": "all"}]


@pytest.mark.parametrize("override", MOVED, ids=lambda o: "-".join(f"{k}={v}"
                                                                  for k, v in o.items()))
def test_each_switch_trains(override):
    """Each value the trainer tests used to refuse trains through
    Trainer.fit (one call: 2 steps at steps_per_call 2, else 1)."""
    state = ttrainer.Trainer(_cfg(**{"train.steps": "1", **override}), device="cpu").fit()
    assert state.step == int(override.get("train.steps_per_call", 1))
    assert all(torch.isfinite(p).all() for p in state.segmentor.parameters())
