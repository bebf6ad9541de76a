"""The dual-decoder training cell on the CPU: the plain reference of the
gated dual decoders and their two critics against the program, the
operation count, the `fit_dual` driver rehearsed at a tiny size, and the
faults of its check coming out not correct."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_TRAIN

CELL = "train-phg-b8"
DEPTHS = {"main": 4, "c": 1}


def _program_segmentor(p):
    from octave_tpu_torch.models.segmentor import ResnestUnetParallelHeadAttentionGate

    model = ResnestUnetParallelHeadAttentionGate(2, gating_level=4)
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(p)
    return model.train()


def _program_critics(crit, hw):
    from octave_tpu_torch.models.discriminator import DiscriminatorBlock

    critic = torch.nn.ModuleDict({n: DiscriminatorBlock((hw, hw), d, 64)
                                  for n, d in DEPTHS.items()})
    critic.load_state_dict(crit)
    return critic.train()


@pytest.mark.parametrize("hw", [64, 80])  # 80: the odd encoder tap padded, as at 304
def test_dual_reference_matches_the_program_in_float32(hw):
    """Both pyramids (5 + 2 levels) and both heads' logits, in training
    mode (batch statistics), on seeded random weights."""
    from reference.dual import DualNet, dual_segmentor_spec
    from reference.model import make_params
    from reference.phantoms import as_rgb, device_phantoms

    torch.set_num_threads(4)
    gen = torch.Generator().manual_seed(5)
    p = make_params(dual_segmentor_spec(), gen, torch.device("cpu"))
    x = as_rgb(device_phantoms(4, hw, gen)).float() / 255
    with torch.no_grad():
        (att, att_c), heads = _program_segmentor(p)(x)
        (ref, ref_c), ref_heads = DualNet(p, train=True).dual(x)
    assert [a.shape[1] for a in att] == [hw // 2 ** i for i in range(5)]
    assert [a.shape[1] for a in att_c] == [hw, hw // 2]
    for got, want in zip(list(att) + list(att_c), ref + ref_c):
        assert (got - want).abs().max() < 1e-4
    for got, want in zip(heads.unbind(0), ref_heads):
        assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_dual_reference_state_dict_names_are_the_programs():
    from octave_tpu_torch.models.discriminator import DiscriminatorBlock
    from octave_tpu_torch.models.segmentor import ResnestUnetParallelHeadAttentionGate
    from reference.dual import critics_spec, dual_segmentor_spec

    def shapes(sd):
        return {k: tuple(v.shape) for k, v in sd.items()}

    seg = ResnestUnetParallelHeadAttentionGate(2, gating_level=4).state_dict()
    assert shapes(seg) == {k: tuple(s) for k, (_, s) in dual_segmentor_spec().items()}
    crit = torch.nn.ModuleDict({n: DiscriminatorBlock((304, 304), d, 64)
                                for n, d in DEPTHS.items()}).state_dict()
    assert shapes(crit) == {k: tuple(s) for k, (_, s) in
                            critics_spec((304, 304), DEPTHS, 64).items()}


def test_dual_reference_train_step_matches_the_programs_in_float32():
    """Two steps of `make_train_step` with the two critics (noise on) and of
    the reference from the same weights and noise seed: every loss, and
    after the first step each leaf's Adam first moment, the `_c` branch's
    and the "c" critic's among them."""
    from octave_tpu_torch.data.preprocess import prepare_batch
    from octave_tpu_torch.train.schedule import make_optimizer, polynomial_decay
    from octave_tpu_torch.train.state import TrainState
    from octave_tpu_torch.train.steps import StepConfig, make_train_step
    from reference.dual import DualTrainer, critics_spec, dual_segmentor_spec
    from reference.model import make_params
    from reference.phantoms import synthetic_octa
    from reference.train import prepare

    torch.set_num_threads(4)
    hw = 64
    gen = torch.Generator().manual_seed(3)
    seg = make_params(dual_segmentor_spec(), gen, torch.device("cpu"))
    crit = make_params(critics_spec((hw, hw), DEPTHS, 64), gen, torch.device("cpu"))
    model, critic = _program_segmentor(seg), _program_critics(crit, hw)
    sched = polynomial_decay(1e-4, 1e-6, 20000, 0.9)
    state = TrainState(segmentor=model, seg_opt=make_optimizer(model.parameters(),
                                                               schedule=sched),
                       critic=critic, critic_opt=make_optimizer(critic.parameters(),
                                                                schedule=sched),
                       generator=torch.Generator().manual_seed(11))
    optim = {"seg_lr": 1e-4, "disc_lr": 1e-4, "end_lr": 1e-6, "decay_steps": 20000, "power": 0.9}
    ref = DualTrainer(seg, crit, DEPTHS, optim, 11, "cpu", torch.float32)
    step = make_train_step(StepConfig(discriminator_depth=4, discriminator_depth_c=1))
    for s in range(2):
        rows = [synthetic_octa(4 * s + i, 9, (hw, hw)) for i in range(4)]
        arrays = [np.stack([r[j] for r in rows]) for j in range(3)]
        got = step(state, prepare_batch(*arrays, size=(hw, hw), device="cpu"))
        want = ref.step(prepare(*arrays, 4, "cpu"))
        assert set(got) == set(want)
        for name, value in want.items():
            assert float(got[name]) == pytest.approx(value, rel=2e-3, abs=1e-6), (s, name)
        if s == 0:
            opt = {**state.seg_opt.opt.state, **state.critic_opt.opt.state}
            leaves = {**{"seg/" + k: p for k, p in model.named_parameters()},
                      **{"critic/" + k: p for k, p in critic.named_parameters()}}
            moments = ref.first_moments()
            assert set(moments) == set(leaves)
            norms = {n: float(torch.linalg.vector_norm(m)) for n, m in moments.items()}
            floor = 1e-3 * float(np.median(list(norms.values())))
            for n, p in leaves.items():
                gap = float(torch.linalg.vector_norm(opt[p]["exp_avg"] - moments[n]))
                assert gap <= 0.05 * max(norms[n], floor), n


def test_dual_operation_count_recomputes():
    import count_ops_dual

    got = count_ops_dual.counts()
    with open(os.path.join(BENCH, "configs", f"{count_ops_dual.DUAL}.json")) as f:
        assert json.load(f)["per_image"] == got[count_ops_dual.DUAL]
    # the `unet` step's 327.34 GFLOP and the second decoder's ~32 GFLOP,
    # forward and backward, with the depth-1 critic's
    assert 360e9 < got[count_ops_dual.DUAL]["train_flops"] < 375e9


# limits at the rehearsal's tiny size on the CPU, between what the sound
# program and a broken one read there (the cell's own limits are set on the
# card at the timed size)
TINY_DUAL_LIMITS = {"loss_sup_first_gap": 0.0006, "loss_ild_first_gap": 0.1,
                    "loss_seg_total_first_gap": 0.06,
                    "grad_median_gap": 0.07, "change_median_gap": 0.1,
                    "change_critic_median_gap": 0.05, "change_critic_c_median_gap": 0.05,
                    "logit_first_gap": 0.025}


def test_fit_dual_driver_rehearsed(rehearse):
    run, res = rehearse(CELL, TINY_TRAIN, {"limits": TINY_DUAL_LIMITS}, seconds=2.0)
    assert res.metrics["train_img_s"] > 0 and res.attempted >= 1
    assert run.setup_s > 0 and res.correct, res.readings
    # the `_c` branch's first moments are compared and reported, under no limit
    assert set(TINY_DUAL_LIMITS) | {"grad_seg_c_median_gap"} <= set(res.readings)


def _freeze_critic_c(monkeypatch):
    """Every step puts the "c" critic's parameters back where they were."""
    from octave_tpu_torch.train import trainer

    base = trainer.make_multi_step

    def frozen(step, k):
        def keep(state, batch):
            c = state.critic["c"]
            before = [p.detach().clone() for p in c.parameters()]
            out = step(state, batch)
            with torch.no_grad():
                for p, v in zip(c.parameters(), before):
                    p.copy_(v)
            return out
        return base(keep, k)

    monkeypatch.setattr(trainer, "make_multi_step", frozen)


def _drop_head_c(monkeypatch):
    """The step sees only the main head's agg map: no `_c` supervised term."""
    from octave_tpu_torch.train import steps

    base = steps.adapt_segmentor_output
    monkeypatch.setattr(steps, "adapt_segmentor_output",
                        lambda out: (base(out)[0], base(out)[1][:1]))


def _drop_ild_c(monkeypatch):
    """The two-level `_c` pyramid's ILD term reads 0."""
    from octave_tpu_torch.train import steps

    base = steps._ild
    monkeypatch.setattr(steps, "_ild", lambda cfg, p: base(cfg, p) * 0 if len(p) == 2
                        else base(cfg, p))


def _half_batch(monkeypatch):
    from octave_tpu_torch.train import trainer

    base = trainer.make_multi_step

    def halving(step, k):
        def half(state, batch):
            def cut(v):
                return [cut(x) for x in v] if isinstance(v, (list, tuple)) else \
                    v[: v.shape[0] // 2]
            return step(state, {n: cut(v) for n, v in batch.items()})
        return base(half, k)

    monkeypatch.setattr(trainer, "make_multi_step", halving)


FAULTS = {"no_sup_c": _drop_head_c, "no_ild_c": _drop_ild_c,
          "frozen_critic_c": _freeze_critic_c, "half_batch": _half_batch}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_dual_training_with_a_broken_step_is_not_correct(rehearse, monkeypatch, fault):
    """The program without the `_c` head's supervised term, without the
    `_c` pyramid's ILD, with the "c" critic never updated, or on half of
    each batch, fails a limit the sound program passes."""
    FAULTS[fault](monkeypatch)
    _, res = rehearse(CELL, TINY_TRAIN, {"limits": TINY_DUAL_LIMITS}, seconds=1.0)
    assert not res.correct, res.readings


def test_dual_training_controls_read_above_the_limits():
    """The reference with float8 operands, on half of each batch, without
    the `_c` head's supervised term, without the `_c` pyramid's ILD, and
    with the "c" critic never updated, in the program's place, fails one of
    the limits the sound program passes (test_fit_dual_driver_rehearsed)."""
    import time

    import control_dual
    from conftest import merge
    from harness import cell

    torch.set_num_threads(4)
    spec = cell.from_files(CELL, 1, [], [])
    merge(spec.config, TINY_TRAIN)
    run = cell.Run(spec, 2 ** 31 + 11, 1.0, False, time.perf_counter(), device="cpu")
    got = control_dual.training_controls(run)
    assert set(got) == {"fp8", "half_batch", "no_sup_c", "no_ild_c", "frozen_critic_c"}
    for name, readings in got.items():
        assert any(readings[k] > v for k, v in TINY_DUAL_LIMITS.items()), (name, readings)
