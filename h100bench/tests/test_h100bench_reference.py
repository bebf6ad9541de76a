"""The plain reference against the program on the CPU at a small size, the
frozen copy of the training phantoms, the drivers rehearsed, and the
check's controls and faults."""
import numpy as np
import pytest
import torch

from conftest import TINY_SERVE, TINY_TRAIN


def _weights(hw, seed=5):
    from reference.model import bn_statistics, make_params, segmentor_spec
    from reference.phantoms import as_rgb, device_phantoms

    gen = torch.Generator().manual_seed(seed)
    p = make_params(segmentor_spec(), gen, torch.device("cpu"))
    images = device_phantoms(6, hw, gen)
    with torch.no_grad():
        p.update(bn_statistics(p, as_rgb(images).float() / 255))
    return p, images


@pytest.mark.parametrize("hw", [64, 80])  # 80: the odd encoder tap padded, as at 304
def test_reference_matches_the_program_in_float32(hw):
    from octave_tpu_torch.serve import Predictor
    from reference.phantoms import as_rgb
    from harness.serving import reference_outputs

    torch.set_num_threads(4)
    p, images = _weights(hw)
    pred = Predictor(p, device="cpu", dtype=torch.float32, use_fused_decoder=False)
    got = pred(as_rgb(images).numpy())
    want = reference_outputs(p, images)
    assert np.abs(got - want).max() < 1e-3


def test_reference_state_dict_names_are_the_programs():
    from octave_tpu_torch.models.discriminator import DiscriminatorBlock
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from reference.model import critic_spec, segmentor_spec

    seg = ResnestUNet(2).state_dict()
    assert {k: tuple(v.shape) for k, v in seg.items()} == {
        k: tuple(s) for k, (_, s) in segmentor_spec().items()}
    crit = DiscriminatorBlock((304, 304), 4, 64).state_dict()
    assert {k: tuple(v.shape) for k, v in crit.items()} == {
        k: tuple(s) for k, (_, s) in critic_spec((304, 304), 4, 64).items()}


def test_reference_train_step_matches_the_programs_in_float32():
    from octave_tpu_torch.data.preprocess import prepare_batch
    from octave_tpu_torch.models.discriminator import DiscriminatorBlock
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.train.schedule import make_optimizer, polynomial_decay
    from octave_tpu_torch.train.state import TrainState
    from octave_tpu_torch.train.steps import StepConfig, make_train_step
    from reference.model import critic_spec, make_params, segmentor_spec
    from reference.phantoms import synthetic_octa
    from reference.train import Trainer, prepare

    torch.set_num_threads(4)
    hw = 64
    gen = torch.Generator().manual_seed(3)
    seg = make_params(segmentor_spec(), gen, torch.device("cpu"))
    crit = make_params(critic_spec((hw, hw), 4, 64), gen, torch.device("cpu"))
    model = ResnestUNet(2).to(memory_format=torch.channels_last)
    model.load_state_dict(seg)
    critic = DiscriminatorBlock((hw, hw), 4, 64)
    critic.load_state_dict(crit)
    sched = polynomial_decay(1e-4, 1e-6, 20000, 0.9)
    state = TrainState(segmentor=model.train(), seg_opt=make_optimizer(model.parameters(),
                                                                       schedule=sched),
                       critic=critic.train(), critic_opt=make_optimizer(critic.parameters(),
                                                                        schedule=sched),
                       generator=torch.Generator().manual_seed(11))
    optim = {"seg_lr": 1e-4, "disc_lr": 1e-4, "end_lr": 1e-6, "decay_steps": 20000, "power": 0.9}
    ref = Trainer(seg, crit, 4, optim, 11, "cpu", torch.float32)
    step = make_train_step(StepConfig())
    for s in range(2):
        # four rows: batch statistics of the split-attention's 1x1 maps over
        # two samples are +-1 whatever the input, and leave its fc1 nothing
        # but round-off to learn from
        rows = [synthetic_octa(4 * s + i, 9, (hw, hw)) for i in range(4)]
        arrays = [np.stack([r[j] for r in rows]) for j in range(3)]
        got = step(state, prepare_batch(*arrays, size=(hw, hw), device="cpu"))
        want = ref.step(prepare(*arrays, 4, "cpu"))
        for name, value in want.items():
            assert float(got[name]) == pytest.approx(value, rel=2e-3, abs=1e-6), (s, name)


def test_frozen_phantoms_are_the_programs_byte_for_byte():
    from octave_tpu_torch.data.datasets import SyntheticOcta, batch_iterator
    from reference.phantoms import batch_indices, synthetic_octa

    ds = SyntheticOcta(size=(48, 48), n=6, seed=2 ** 31 + 3)
    for i in (0, 5):
        s = ds[i]
        img, scrib, mask = synthetic_octa(i, 2 ** 31 + 3, (48, 48))
        assert np.array_equal(s.image, img) and np.array_equal(s.scribble, scrib)
        assert np.array_equal(s.mask, mask)
    it = batch_iterator(ds, 2, seed=2 ** 31 + 3)
    idx = batch_indices(6, 2, 2 ** 31 + 3, 4)
    for row in idx:
        got = next(it)["image"]
        assert np.array_equal(got, np.stack([ds[int(i)].image for i in row]))


def test_bulk_driver_rehearsed(rehearse):
    run, res = rehearse("serve-int8-bulk-b256", TINY_SERVE,
                        {"batch": 4, "distinct_batches": 2, "sample_dispatches": 3,
                         "rows_per_dispatch": 4, "limits": TINY_SERVE_LIMITS})
    assert res.metrics["serve_img_s"] > 0 and res.attempted % 4 == 0
    assert run.setup_s > 0 and res.correct, res.readings


def test_fit_driver_rehearsed(rehearse):
    run, res = rehearse("train-adv-b8-k1", TINY_TRAIN, {"limits": TINY_TRAIN_LIMITS},
                        seconds=2.0)
    assert res.metrics["train_img_s"] > 0 and res.attempted >= 1
    assert run.setup_s > 0 and res.correct, res.readings


# limits at the rehearsal's tiny size on the CPU, between what the sound
# program and a broken one read there (the cells' own limits are set on the
# card at the timed sizes)
TINY_SERVE_LIMITS = {"logit_rel_err": 0.07, "excess_gap": 1.1}
TINY_TRAIN_LIMITS = {"loss_sup_first_gap": 0.0006, "loss_seg_total_first_gap": 0.06,
                     "grad_median_gap": 0.07, "change_median_gap": 0.1,
                     "change_critic_median_gap": 0.05}


def test_serving_with_an_answer_altered_is_not_correct(rehearse, monkeypatch):
    """The timed path broken underneath: each dispatch's first answer has
    its classes swapped."""
    from octave_tpu_torch import serve

    base = serve._stack_forward

    def altered(model, stack, **kw):
        out = base(model, stack, **kw)
        out[:, 0] = out[:, 0].flip(-1)
        return out

    monkeypatch.setattr(serve, "_stack_forward", altered)
    wl = {"batch": 4, "distinct_batches": 2, "sample_dispatches": 3, "rows_per_dispatch": 4,
          "limits": TINY_SERVE_LIMITS}
    _, res = rehearse("serve-int8-bulk-b256", TINY_SERVE, wl)
    assert not res.correct, res.readings


# a fault planted in the program's configuration alone: (section, key, value)
DEPARTURES = {"no_ild": ("loss", "lambda_ild", 0.0), "no_adv": ("loss", "lambda_adv", 0.0),
              "frozen_critic": ("optim", "disc_lr", 0.0)}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", *DEPARTURES])
def test_training_with_a_broken_step_is_not_correct(rehearse, monkeypatch, fault):
    """A step that returns its state unchanged (no optimizer updates); a
    step on half of its batch, its mean taken over the rest; a step without
    the ILD or the adversarial term; a critic that never moves."""
    import copy

    from octave_tpu_torch.train import schedule, trainer

    if fault == "unchanged":
        monkeypatch.setattr(schedule.Optimizer, "step", lambda self: self.sched.step())
    elif fault in DEPARTURES:
        section, key, value = DEPARTURES[fault]
        base_init = trainer.Trainer.__init__

        def departing(self, cfg, *args, **kw):
            cfg = copy.deepcopy(cfg)
            setattr(getattr(cfg, section), key, value)
            base_init(self, cfg, *args, **kw)

        monkeypatch.setattr(trainer.Trainer, "__init__", departing)
    else:
        base = trainer.make_multi_step

        def halving(step, k):
            def half(state, batch):
                def cut(v):
                    return [cut(x) for x in v] if isinstance(v, (list, tuple)) else \
                        v[: v.shape[0] // 2]
                return step(state, {n: cut(v) for n, v in batch.items()})
            return base(half, k)

        monkeypatch.setattr(trainer, "make_multi_step", halving)
    _, res = rehearse("train-adv-b8-k1", TINY_TRAIN, {"limits": TINY_TRAIN_LIMITS},
                      seconds=1.0)
    assert not res.correct, res.readings


def _control_run(name, cfg, wl):
    import time

    from conftest import merge
    from harness import cell

    spec = cell.from_files(name, 1, [], [])
    merge(spec.config, cfg)
    merge(spec.workload, wl)
    return cell.Run(spec, 2 ** 31 + 11, 1.0, False, time.perf_counter(), device="cpu")


def test_serving_control_reads_above_the_limit():
    """The reference with its decoder in int4, in the program's place, an
    altered answer, and the program's own int8-everywhere path, fail a
    limit the sound program passes (at the tiny size:
    test_bulk_driver_rehearsed)."""
    import control

    torch.set_num_threads(4)
    run = _control_run("serve-int8-bulk-b256", TINY_SERVE,
                       {"sample_dispatches": 3, "rows_per_dispatch": 2})
    got = control.serving_controls(run)
    limit = TINY_SERVE_LIMITS["logit_rel_err"]
    assert got["int4_decoder"]["logit_rel_err"] > limit
    assert got["answer_altered"]["logit_rel_err"] > limit
    assert got["program_int8_all"]["excess_gap"] > TINY_SERVE_LIMITS["excess_gap"]


def test_training_control_reads_above_the_limits():
    """The reference with float8 operands, on half of each batch, without
    the ILD or the adversarial term, and with its critic frozen, fails one
    of the limits the sound program passes (test_fit_driver_rehearsed)."""
    import control

    torch.set_num_threads(4)
    run = _control_run("train-adv-b8-k1", TINY_TRAIN, {})
    got = control.training_controls(run)
    for name in ("fp8", "half_batch", "no_ild", "no_adv", "frozen_critic"):
        assert any(got[name][k] > v for k, v in TINY_TRAIN_LIMITS.items()), (name, got[name])
