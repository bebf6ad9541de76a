"""The port's Trainer, CLI and metrics on the CPU.

A 2-step `Trainer.fit` plus `evaluate` at 32² on the synthetic phantoms,
the `train` command line, the options the port does not have (each must
raise) and those it has, the CUDA default, the bf16 step under
CPU autocast, and the metric accumulators against the JAX package's.
"""
import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octave_tpu.utils import metrics as jmetrics
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.train.trainer import Trainer, build_dataset
from octave_tpu_torch.utils import metrics as tmetrics
from octave_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
SMALL = {"train.steps": "2", "data.image_size": "[32,32]", "data.synthetic_n": "4",
         "data.batch_size": "2", "train.eval_every": "0", "train.log_every": "1"}


def _cfg(**extra):
    return Config.load(SMOKE).apply_overrides({**SMALL, **extra})


def test_fit_and_evaluate(tmp_path):
    """Two steps change all four kinds of state; the log holds every loss;
    evaluate gives dataset-level metrics in range."""
    cfg = _cfg(**{"train.log_dir": str(tmp_path)})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    seg0 = {k: v.clone() for k, v in state.segmentor.state_dict().items()}
    critic0 = {k: v.clone() for k, v in state.critic.state_dict().items()}
    state = trainer.fit(state)
    assert state.step == 2
    seg1, critic1 = state.segmentor.state_dict(), state.critic.state_dict()
    assert not torch.equal(seg0["fc.weight"], seg1["fc.weight"])
    assert not torch.equal(seg0["encoder_1.0.bn1.running_mean"],
                           seg1["encoder_1.0.bn1.running_mean"])
    assert not torch.equal(critic0["out.0.weight"], critic1["out.0.weight"])
    uv = "spectral_dict.spectral_0.0.weight_u"
    assert not torch.equal(critic0[uv], critic1[uv])
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        for k in ("loss_sup", "loss_ild", "loss_adv", "loss_seg_total", "loss_disc"):
            assert np.isfinite(r[f"train/{k}"]), k
    metrics = trainer.evaluate(state)
    assert set(metrics) == {"dice", "iou", "accuracy", "sensitivity", "specificity", "auc"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())


def test_weak_only_and_depth_clamp():
    """discriminator_depth 0 trains without a critic; a gating level below
    the critic's depth clamps the critic to the pyramid the model emits."""
    t = Trainer(_cfg(**{"model.discriminator_depth": "0", "loss.lambda_adv": "0"}),
                device="cpu")
    state = t.fit()
    assert state.critic is None and state.step == 2
    t = Trainer(_cfg(**{"model.segmentor_gating_level": "2"}), device="cpu")
    assert t.disc_depth == 2 and t.init_state().critic.depth == 2


@pytest.mark.parametrize("override,item", [
    ({"train.compute_dtype": "float64"}, None),
])
def test_unported_options_raise(override, item):
    """A compute dtype outside None, float32, bfloat16 and float16 raises."""
    with pytest.raises(ValueError) as e:
        Trainer(_cfg(**override), device="cpu")
    if item is not None:
        assert f"ROADMAP {item}" in str(e.value)


@pytest.mark.parametrize("override", [
    {"model.pretrain": "true"},
    {"data.dataset": "rose"},
    {"data.dataset": "octa500"},
    {"data.augment": "true", "data.augment_intensity": "0.1"},
    {"train.checkpoint_dir": "/nonexistent/ckpt"},
    {"train.profile_dir": "/nonexistent/prof"},
    {"model.architecture": "parallel_head"},
    {"model.encoder_gating": "true"},
    {"model.architecture": "parallel_head_gate"},
    {"train.remat": "block-enc"},
    {"train.remat": "block:012"},
    {"optim.moment_dtype": "bfloat16"},
    {"optim.moment_dtype": "float32"},
    {"train.remat": "block"},
    {"train.dense_groups": "decoder"},
    {"train.einsum_groups": "decoder"},
    {"train.steps_per_call": "2"},
    {"train.remat": "conv"},
    {"train.dense_groups": "all"},
    {"train.compute_dtype": "float16"},
    {"train.compute_dtype": "float32"},
])
def test_ported_options_are_accepted(override):
    """What the deployment, model-family and memory-switch slices ported no
    longer raises at construction (tests/test_torch_switches.py trains
    each switch)."""
    Trainer(_cfg(**override), device="cpu")


# -- the graphed step: which configurations it captures, and its host side ------
REMAT_MODES = [False, True, "conv", "block", "block-enc", "block:012", "block:01e34",
               "block:012+conv"]
GRAPH_TABLE = [(dp, remat, dtype) for dp in (False, True) for remat in REMAT_MODES
               for dtype in (None, "float32", "bfloat16", "float16")]


@pytest.mark.parametrize("data_parallel,remat,dtype", GRAPH_TABLE,
                         ids=lambda v: str(v).lower())
def test_graph_table(data_parallel, remat, dtype):
    """On CUDA every single-device configuration is captured, in every remat
    mode and compute dtype; data parallelism stays eager."""
    from octave_tpu_torch.train.steps import StepConfig, graph_blocker

    reason = graph_blocker(StepConfig(remat=remat, compute_dtype=dtype,
                                      data_parallel=data_parallel))
    if data_parallel:
        assert reason is not None and "data_parallel" in reason
    else:
        assert reason is None


def test_graph_table_refuses_unknown_values():
    from octave_tpu_torch.train.steps import StepConfig, graph_blocker

    with pytest.raises(ValueError, match="remat"):
        graph_blocker(StepConfig(remat="bogus"))
    with pytest.raises(ValueError, match="compute_dtype"):
        graph_blocker(StepConfig(compute_dtype="int8"))


def test_cpu_trainer_is_eager(caplog):
    """The CPU runs the step eagerly and says so once per fit; asking it for
    a graph raises."""
    trainer = Trainer(_cfg(), device="cpu")
    assert trainer.graphed is False and "cpu" in trainer.eager_reason
    assert Trainer(_cfg(), device="cpu", graphed=False).eager_reason == "graphed=False"
    with pytest.raises(ValueError, match="cannot be captured"):
        Trainer(_cfg(), device="cpu", graphed=True)
    state = trainer.init_state()
    assert trainer.step_call(state) is trainer.train_step and state.graph is None
    with caplog.at_level("INFO", logger="octave_tpu_torch"):
        trainer.fit(state)
    assert [r.getMessage() for r in caplog.records if "train step" in r.getMessage()] == [
        "train step: eager (no CUDA graphs on cpu)"]


@pytest.mark.parametrize("k", [1, 2])
def test_call_batch_writes_into_static_inputs(k):
    """`call_batch(out=...)` writes a call's batch into a captured step's
    static input, leaf by leaf (the pyramid's levels too), and returns it."""
    trainer = Trainer(_cfg(**{"train.steps_per_call": str(k), "data.augment": "true"}),
                      device="cpu")
    hosts = list(itertools.islice(ds.batch_iterator(build_dataset(trainer.cfg), 2, seed=0),
                                  2 * k))
    gen = torch.Generator()
    want = trainer.call_batch(hosts[k:], k, gen)
    static = trainer.call_batch(hosts[:k], 0, gen)
    leaves = {name: (v if torch.is_tensor(v) else list(v)) for name, v in static.items()}
    got = trainer.call_batch(hosts[k:], k, gen, out=static)
    assert got is static
    for name, v in want.items():
        if torch.is_tensor(v):
            assert got[name] is leaves[name] and torch.equal(got[name], v)
        else:
            assert all(a is b and torch.equal(a, c)
                       for a, b, c in zip(got[name], leaves[name], v, strict=True))


def test_graphed_losses_are_copies():
    """A replay overwrites the graph's loss tensors in place: what a call
    returns (and `fit` keeps in its log window) is a copy that no later
    replay touches, one device copy for all the losses."""
    from octave_tpu_torch.train.steps import _copied

    static = {"loss_sup": torch.tensor(1.0), "loss_disc": torch.tensor(2.0)}
    first = _copied(static)
    for v in static.values():
        v.add_(10.0)  # the next replay
    second = _copied(static)
    assert {k: float(v) for k, v in first.items()} == {"loss_sup": 1.0, "loss_disc": 2.0}
    assert {k: float(v) for k, v in second.items()} == {"loss_sup": 11.0, "loss_disc": 12.0}
    ptrs = {v.untyped_storage().data_ptr() for v in static.values()}
    assert ptrs.isdisjoint(v.untyped_storage().data_ptr() for v in first.values())
    assert first["loss_sup"].untyped_storage().data_ptr() != \
        second["loss_sup"].untyped_storage().data_ptr()


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_cfg())


def test_bf16_step_on_cpu_autocast():
    """compute_dtype='bfloat16' runs both forwards under autocast with float32
    master weights; its losses sit near the float32 step's."""
    losses = {}
    for dtype in (None, "bfloat16"):
        t = Trainer(_cfg(**({"train.compute_dtype": dtype} if dtype else {}),
                         **{"model.instance_noise": "false", "model.label_noise": "false"}),
                    device="cpu")
        state = t.init_state()
        batch = t.device_batch(next(ds.batch_iterator(build_dataset(t.cfg), 2, seed=0)))
        losses[dtype] = {k: v.item() for k, v in t.train_step(state, batch).items()}
        assert all(p.dtype == torch.float32 for p in state.segmentor.parameters())
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in state.segmentor.parameters())
    for k, v in losses[None].items():
        assert np.isfinite(losses["bfloat16"][k])
        assert abs(losses["bfloat16"][k] - v) <= 0.1 * abs(v) + 1e-3, (k, v, losses["bfloat16"][k])


def test_cli_train_drive():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    args = [sys.executable, "-m", "octave_tpu_torch.cli", "train", "--config", SMOKE,
            "train.steps=2", "data.image_size=[32,32]", "data.synthetic_n=4",
            "data.batch_size=2", "train.eval_every=0"]
    r = subprocess.run(args + ["--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "'dice':" in r.stdout and "'auc':" in r.stdout
    if not torch.cuda.is_available():
        r = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    target = (rng.uniform(0, 1, (3, 8, 8)) > 0.6).astype(np.float32)
    weight = np.array([1, 0, 1], np.float32)
    want = jmetrics.eval_step_metrics(jnp.asarray(probs), jnp.asarray(target))
    got = tmetrics.eval_step_metrics(torch.from_numpy(probs), torch.from_numpy(target))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)
    pred = (probs >= 0.5).astype(np.float32)
    jc = jmetrics.ConfusionAccumulator.empty().update(jnp.asarray(pred), jnp.asarray(target),
                                                      jnp.asarray(weight))
    tc = tmetrics.ConfusionAccumulator.empty(device="cpu").update(torch.from_numpy(pred),
                                                      torch.from_numpy(target),
                                                      torch.from_numpy(weight))
    assert [int(x) for x in tc.astype64()] == [int(x) for x in jc]
    ja = jmetrics.AucAccumulator.empty().update(jnp.asarray(probs), jnp.asarray(target),
                                                jnp.asarray(weight))
    ta = tmetrics.AucAccumulator.empty(device="cpu").update(torch.from_numpy(probs),
                                                torch.from_numpy(target),
                                                torch.from_numpy(weight))
    for a, b in zip(ta.astype64(), ja.astype64()):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(float(ta.astype64().auc()), float(ja.astype64().auc()),
                               rtol=1e-12)
    host = tmetrics.ConfusionAccumulator.empty_host()
    host = tmetrics.ConfusionAccumulator(*(x + y for x, y in zip(host, tc.astype64())))
    assert all(isinstance(x, np.int64) for x in host) and 0 <= host.dice() <= 1
