"""The port's checkpoints and the compact weights npz on the CPU.

A TrainState saved and restored into a fresh state must be bit-exact in every
tensor of both modules, both optimizers, the schedule counters, the noise
generator and the step, and the step taken after the restore must equal, bit
for bit, the step taken without the round trip. `Trainer.fit` resumes at the
saved step, a SIGTERM saves and stops, and `export_weights_npz` /
`load_weights_npz` read and write the JAX package's files bit for bit.
"""
import logging
import os
import shutil
import signal

import ml_dtypes
import numpy as np
import pytest
import torch

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.utils import checkpoint as jckpt
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.train.trainer import Trainer, build_dataset
from octave_tpu_torch.utils import checkpoint as tckpt
from octave_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
SMALL = {"train.steps": "2", "data.image_size": "[32,32]", "data.synthetic_n": "4",
         "data.batch_size": "2", "train.eval_every": "0", "train.log_every": "0",
         "optim.grad_clip": 1.0, "optim.weight_decay": "0.01"}


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A full train state is ~0.9 GB on disk: leave none behind."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny_state():
    """A TrainState of two small modules, for the manager's bookkeeping."""
    from octave_tpu_torch.train.schedule import make_optimizer, polynomial_decay
    from octave_tpu_torch.train.state import TrainState

    torch.manual_seed(0)
    seg, critic = torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(4, 2)
    opts = [make_optimizer(m.parameters(), schedule=polynomial_decay(1e-3, 1e-6, 10, 0.9))
            for m in (seg, critic)]
    seg(torch.randn(1, 3, 8, 8)).sum().backward()
    opts[0].step()
    return TrainState(segmentor=seg, seg_opt=opts[0], critic=critic, critic_opt=opts[1],
                      generator=torch.Generator().manual_seed(1), step=1)


def _trainer(**extra):
    return Trainer(Config.load(SMOKE).apply_overrides({**SMALL, **extra}), device="cpu")


def _leaves(obj, path=""):
    """(path, leaf) of every tensor and scalar in a nested state."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, obj


def _assert_states_equal(a, b):
    la, lb = dict(_leaves(tckpt.state_to_dict(a))), dict(_leaves(tckpt.state_to_dict(b)))
    assert la.keys() == lb.keys()
    n_tensors = 0
    for k, v in la.items():
        if torch.is_tensor(v):
            n_tensors += 1
            assert v.dtype == lb[k].dtype and v.stride() == lb[k].stride(), k
            assert torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k
    return n_tensors


@pytest.fixture(scope="module")
def trained():
    """(trainer, state after 2 steps, one prepared batch)."""
    tr = _trainer()
    state = tr.fit()
    batch = tr.device_batch(next(ds.batch_iterator(build_dataset(tr.cfg), 2, seed=5)))
    return tr, state, batch


def test_roundtrip_is_bit_exact(trained, tmp_path):
    tr, state, _ = trained
    mgr = tckpt.CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(tr.init_state()) is None
    assert mgr.save(2, state) is True
    mgr.wait()
    assert mgr.save(2, state) is False  # the step has its checkpoint
    assert mgr.latest_step() == 2
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    fresh = tr.init_state()
    assert not torch.equal(fresh.segmentor.state_dict()["fc.weight"],
                           state.segmentor.state_dict()["fc.weight"])
    restored = mgr.restore_latest(fresh)
    assert restored is fresh and restored.step == 2
    n = _assert_states_equal(restored, state)
    assert n > 1500  # parameters, BN stats, u/v, two Adam moments each, the generator
    sd = tckpt.state_to_dict(restored)
    # what the state must hold: BN running stats, spectral u/v, moments, counters
    assert "encoder_1.0.bn1.running_mean" in sd["segmentor"]
    assert "spectral_dict.spectral_0.0.weight_u" in sd["critic"]
    assert sd["seg_opt"]["sched"]["last_epoch"] == 2 == sd["critic_opt"]["sched"]["last_epoch"]
    moments = sd["seg_opt"]["opt"]["state"][0]
    assert set(moments) >= {"step", "exp_avg", "exp_avg_sq"} and float(moments["step"]) == 2
    assert restored.seg_opt.opt.param_groups[0]["lr"] == state.seg_opt.opt.param_groups[0]["lr"]
    mgr.close()


def test_step_after_restore_is_bit_exact(trained, tmp_path):
    """The snapshot is taken before the next step mutates the live state, and
    the restored state steps exactly as the live one."""
    tr, state, batch = trained
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    live_losses = tr.train_step(state, batch)  # mutates `state` while the write may run
    restored = mgr.restore_latest(tr.init_state())
    assert restored.step == state.step - 1
    restored_losses = tr.train_step(restored, batch)
    for k, v in live_losses.items():
        assert torch.equal(v, restored_losses[k]), k
    _assert_states_equal(restored, state)
    mgr.close()


def test_max_to_keep_and_interval(tmp_path):
    state = _tiny_state()
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=2)
    saved = [mgr.save(s, state) for s in range(1, 9)]
    mgr.close()
    assert saved == [False, True] * 4
    assert mgr.all_steps() == [6, 8]
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000008"]


def test_half_written_checkpoint_is_ignored(tmp_path):
    state = _tiny_state()
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    mgr.wait()
    os.makedirs(tmp_path / "step_00000009")  # final name, no file: never produced by save
    os.makedirs(tmp_path / "tmp.7.12345")  # a writer that died before its rename
    (tmp_path / "tmp.7.12345" / "state.pt").write_bytes(b"half")
    assert mgr.all_steps() == [3]
    restored = mgr.restore_latest(_tiny_state())
    assert restored.step == state.step
    _assert_states_equal(restored, state)
    mgr.close()


def test_write_failure_surfaces(tmp_path, monkeypatch):
    state = _tiny_state()
    mgr = tckpt.CheckpointManager(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    mgr.save(1, state)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []


def test_weak_only_state_and_mismatch(tmp_path):
    """A state without critic round-trips; restoring it into a state with one raises."""
    weak = _trainer(**{"model.discriminator_depth": "0", "loss.lambda_adv": "0",
                       "train.steps": "1"})
    state = weak.fit()
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    _assert_states_equal(mgr.restore_latest(weak.init_state()), state)
    with pytest.raises(ValueError, match="critic"):
        mgr.restore_latest(_trainer().init_state())
    mgr.close()


def test_fit_resumes_at_the_saved_step(tmp_path, caplog):
    over = {"train.checkpoint_dir": str(tmp_path / "ckpt"), "train.checkpoint_every": "2"}
    first = _trainer(**over).fit()
    assert first.step == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002"]
    with caplog.at_level(logging.INFO, logger="octave_tpu_torch"):
        tr = _trainer(**over, **{"train.steps": "3"})
        second = tr.fit()
    assert "resumed from step 2" in caplog.text
    assert second.step == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002", "step_00000003"]
    # a run that is already at its last step trains no further
    again = _trainer(**over, **{"train.steps": "3"}).fit()
    _assert_states_equal(again, second)


def test_resumed_fit_equals_the_uninterrupted_fit(tmp_path):
    """7 phantoms in batches of 4: one batch per epoch, each from that
    epoch's permutation. `fit` to 2 steps, then a resume to 4, equals `fit`
    to 4 bit for bit: the resumed steps 3 and 4 take the batches of epochs 2
    and 3, as the uninterrupted run does."""
    data = {"data.synthetic_n": "7", "data.batch_size": "4", "train.steps": "4"}
    whole = _trainer(**data).fit()
    over = {**data, "train.checkpoint_dir": str(tmp_path / "ckpt"),
            "train.checkpoint_every": "2"}
    assert _trainer(**{**over, "train.steps": "2"}).fit().step == 2
    resumed = _trainer(**over).fit()
    assert resumed.step == 4
    _assert_states_equal(resumed, whole)


def test_sigterm_saves_and_stops(tmp_path):
    tr = _trainer(**{"train.checkpoint_dir": str(tmp_path), "train.steps": "5",
                     "train.checkpoint_every": "0"})
    step = tr.train_step

    def step_then_sigterm(state, batch):
        losses = step(state, batch)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return losses

    tr.train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    state = tr.fit()
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 2
    assert os.listdir(tmp_path) == ["step_00000002"]
    restored = tckpt.CheckpointManager(str(tmp_path)).restore_latest(tr.init_state())
    _assert_states_equal(restored, state)


def test_profile_dir_writes_a_trace(tmp_path):
    tr = _trainer(**{"train.profile_dir": str(tmp_path), "train.steps": "1"})
    tr.fit()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 1000


# -- the compact weights npz -------------------------------------------------
def _tree(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {
        "params": {
            "conv": {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32)},
            "bn": {"scale": rng.randn(16).astype(np.float32)},
        },
        "batch_stats": {"bn": {
            "mean": rng.randn(16).astype(np.float32),
            "var": rng.rand(16).astype(np.float32),
            "count": np.asarray(7, np.int64),
        }},
    }


def _flat(tree):
    return dict(tckpt._flatten(tree))


def _assert_bf16_roundtrip(orig, loaded):
    fo, fl = _flat(orig), _flat(loaded)
    assert fo.keys() == fl.keys()
    for k, v in fo.items():
        want = v.astype(ml_dtypes.bfloat16).astype(np.float32) if v.dtype == np.float32 else v
        assert fl[k].dtype == want.dtype and np.array_equal(want, fl[k]), k


def test_f32_to_bf16_bits_is_round_to_nearest_even(rng):
    vals = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4096),
        np.array([0.0, -0.0, np.inf, -np.inf, 1.0, 1.00390625, 1.01171875, 3.3895314e38,
                  1e-40, -1e-45], np.float32),  # ties both ways, overflow to inf, subnormals
    ]).astype(np.float32)
    want = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tckpt.f32_to_bf16_bits(vals), want)
    nan = tckpt.f32_to_bf16_bits(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(tckpt.bf16_bits_to_f32(nan)).all()
    np.testing.assert_array_equal(tckpt.bf16_bits_to_f32(want),
                                  vals.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("max_bytes", [None, 1024])
@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("torch", "jax"),
                                           ("jax", "torch")])
def test_npz_roundtrip_between_packages(tmp_path, writer, reader, max_bytes):
    """Each package reads the other's export, single file or shards, with the
    same keys and bits (the cases of tests/test_weights_npz.py)."""
    mods = {"torch": tckpt, "jax": jckpt}
    tree = _tree(1)
    path = str(tmp_path / "w.npz")
    mods[writer].export_weights_npz(path, tree, max_bytes=max_bytes)
    shards = sorted(tmp_path.glob("w-shard*-of-*.npz"))
    if max_bytes is None:
        assert os.path.isfile(path) and not shards
    else:
        assert not os.path.exists(path) and len(shards) >= 2
    _assert_bf16_roundtrip(tree, mods[reader].load_weights_npz(path))


def test_npz_files_are_identical_between_packages(tmp_path):
    tree = _tree(3)
    tckpt.export_weights_npz(str(tmp_path / "t.npz"), tree, max_bytes=1024)
    jckpt.export_weights_npz(str(tmp_path / "j.npz"), tree, max_bytes=1024)
    ts, js = sorted(tmp_path.glob("t-shard*")), sorted(tmp_path.glob("j-shard*"))
    assert len(ts) == len(js) >= 2
    for a, b in zip(ts, js):
        with np.load(a) as da, np.load(b) as db:
            assert da.files == db.files
            for k in da.files:
                assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), k


def test_npz_incomplete_and_missing_raise(tmp_path):
    path = str(tmp_path / "w.npz")
    tckpt.export_weights_npz(path, _tree(2), max_bytes=1024)
    os.remove(sorted(tmp_path.glob("w-shard*-of-*.npz"))[-1])
    with pytest.raises(FileNotFoundError):
        tckpt.load_weights_npz(path)
    with pytest.raises(FileNotFoundError):
        tckpt.load_weights_npz(str(tmp_path / "nope.npz"))


def test_export_of_a_module_state_dict(trained, tmp_path):
    """A module's state dict exports under its own flat keys; float32 leaves
    come back bf16-rounded, the BN step counters verbatim."""
    _, state, _ = trained
    sd = {k: v for k, v in state.segmentor.state_dict().items()
          if k.startswith(("fc.", "decoder_0.", "encoder_1.0."))}
    path = str(tmp_path / "seg.npz")
    tckpt.export_weights_npz(path, sd, max_bytes=64 * 2**10)
    assert len(list(tmp_path.glob("seg-shard*-of-*.npz"))) >= 2
    loaded = tckpt.load_weights_npz(path)
    assert loaded.keys() == sd.keys()
    for k in ("fc.weight", "encoder_1.0.bn1.running_var", "decoder_0.conv.3.conv.bias"):
        np.testing.assert_array_equal(loaded[k], sd[k].bfloat16().float().numpy())
    k = "encoder_1.0.bn1.num_batches_tracked"
    assert loaded[k].dtype == np.int64 and int(loaded[k]) == int(sd[k])


def test_save_and_load_pytree(tmp_path):
    tree = {"backbone.conv1.0.weight": torch.randn(4, 3, 3, 3), "n": {"b": torch.arange(3)}}
    path = str(tmp_path / "sub" / "w.pt")
    tckpt.save_pytree(path, tree)
    back = tckpt.load_pytree(path)
    assert torch.equal(back["backbone.conv1.0.weight"], tree["backbone.conv1.0.weight"])
    assert torch.equal(back["n"]["b"], tree["n"]["b"])
