"""The port's tracing on the CPU (`octave_tpu_torch/utils/profiling.py`).

Spans enter `torch.profiler.record_function` only while a profiler records,
nest as written, and share the profiler's clock with the set-up phases; the
counter registry holds under threads; the Predictor, `Trainer.fit` and the
BatchServer record their spans, phases and counts; the rewritten fit loop
trains as the loop it replaced did.
"""
import json
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.ops import kernels
from octave_tpu_torch.serve import BatchServer, Predictor
from octave_tpu_torch.train.trainer import Trainer, build_dataset
from octave_tpu_torch.utils import profiling
from octave_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
FIT = {"train.steps": "3", "data.image_size": "[32,32]", "data.synthetic_n": "4",
       "data.batch_size": "2", "train.eval_every": "0", "train.log_every": "2",
       "data.augment": "true"}
HW = (32, 32)


def _events(prof):
    """(name, start ns, end ns) of the profile's `octave.*` host events."""
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.name().startswith("octave.")]


def _since(t_ns):
    return [p for p in profiling.phases() if p.start_ns >= t_ns]


def test_span_without_profiler_never_enters_record_function(monkeypatch):
    """With no profiler running a span is the shared no-op (a phase's span
    too): `record_function`, ~10 us even then, is never built."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("octave.test.off", k=4) as a:
        with profiling.span("octave.test.inner") as b:
            pass
    assert a is b is profiling.span("octave.test.other")
    t = time.time_ns()
    with profiling.phase("octave.test.phase_off"):
        pass
    assert [p.name for p in _since(t)] == ["octave.test.phase_off"]


def test_spans_nest_under_a_cpu_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("octave.test.outer", k=2):
            with profiling.span("octave.test.inner"):
                torch.ones(8).sum()
            with profiling.span("octave.test.inner"):
                torch.ones(8).sum()
    ev = _events(prof)
    assert Counter(n for n, _, _ in ev) == {"octave.test.outer": 1, "octave.test.inner": 2}
    (_, o0, o1), = [e for e in ev if e[0] == "octave.test.outer"]
    inner = sorted(e[1:] for e in ev if e[0] == "octave.test.inner")
    assert o0 <= inner[0][0] < inner[0][1] <= inner[1][0] < inner[1][1] <= o1


def test_phase_stamps_share_the_profiler_clock():
    """A phase's time.time_ns() stamps lie within 1 ms of its own span's
    start and end in the profile; nested phases name their parent; a phase
    that raises is recorded too."""
    t = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.phase("octave.test.setup"):
            with profiling.phase("octave.test.child"):
                torch.randn(64, 64) @ torch.randn(64, 64)
        with pytest.raises(ValueError):
            with profiling.phase("octave.test.fails"):
                raise ValueError("x")
    recs = {p.name: p for p in _since(t)}
    assert recs["octave.test.setup"].parent is None
    assert recs["octave.test.child"].parent == "octave.test.setup"
    assert "octave.test.fails" in recs
    for name, a, b in _events(prof):
        p = recs[name]
        assert abs(a - p.start_ns) < 1e6 and abs(b - p.end_ns) < 1e6, (name, a, p)
        assert p.reserved_start == p.reserved_end == 0  # no CUDA in this process
    assert {n for n, _, _ in _events(prof)} == set(recs)


def test_phase_list_is_bounded():
    for i in range(profiling.MAX_PHASES + 10):
        with profiling.phase(f"octave.test.bound{i}"):
            pass
    got = profiling.phases()
    assert len(got) == profiling.MAX_PHASES
    assert got[-1].name == f"octave.test.bound{profiling.MAX_PHASES + 9}"


def test_counters_hold_under_threads():
    """More threads than cores raising one counter and a kernel count with a
    short switch interval: no update is lost; a reset zeroes every counter
    in one step."""
    wrapper = kernels.Counted("test_threads", lambda: None)
    before = profiling.counter("octave.test.threads")
    n_threads, n = 4 * (os.cpu_count() or 1), 500

    def work():
        for _ in range(n):
            profiling.count("octave.test.threads")
            kernels.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert profiling.counter("octave.test.threads") - before == n_threads * n
    assert wrapper.launches == n_threads * n
    got = profiling.counters(reset=True)
    assert got[wrapper.counter] == n_threads * n
    assert set(profiling.counters().values()) == {0}


def test_kernel_launch_counts_live_in_the_registry():
    """The kernel wrappers' `launches` are the registry's `launches.<name>`
    counters: read, set and reset through either side."""
    from octave_tpu_torch.ops.kernels.aag import fused_aag

    fused_aag.launches = 3
    assert profiling.counters()["launches.aag"] == 3 == kernels.launch_counts()["aag"]
    kernels.count_launch(fused_aag)
    assert kernels.launch_counts(reset=True)["aag"] == 4
    assert fused_aag.launches == 0 == profiling.counter("launches.aag")
    assert "int8_mm" not in kernels.launch_counts()
    assert "launches.int8_mm" in profiling.counters()
    assert fused_aag.__name__ == "fused_aag" and fused_aag.__doc__


def test_int8_predictor_records_its_phases_and_dispatch_spans():
    """An eager CPU Predictor with the int8 decoder records its build,
    calibration and quantisation as phases, in that order; under a profiler
    every dispatch of predict_stream is one dispatch span and one result
    span holding one wait span."""
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    t = time.time_ns()
    pred = Predictor.initialize(image_hw=HW, device="cpu", int8_decoder=True,
                                calibration_batches=[batch])
    assert [p.name for p in _since(t)] == ["octave.predictor.build", "octave.quant.calibrate",
                                          "octave.quant.quantize"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = list(pred.predict_stream([batch] * 5, depth=2))
    assert len(outs) == 5
    ev = _events(prof)
    assert Counter(n for n, _, _ in ev) == {"octave.predictor.dispatch": 5,
                                           "octave.predictor.result": 5,
                                           "octave.predictor.wait": 5}
    results = [e[1:] for e in ev if e[0] == "octave.predictor.result"]
    for _, a, b in (e for e in ev if e[0] == "octave.predictor.wait"):
        assert any(r0 <= a and b <= r1 for r0, r1 in results)


def _fit_config(tmp_path=None):
    extra = {"train.profile_dir": str(tmp_path)} if tmp_path is not None else {}
    return Config.load(SMOKE).apply_overrides({**FIT, **extra})


def test_fit_records_one_set_of_spans_per_call(tmp_path):
    """A profiled CPU fit (`train.profile_dir`'s Chrome trace) of 3 calls:
    one `call_batch` and one `step` span per call, one `call` and one
    `next_batch` span per draw (the 3 calls' and the draw that finds the
    step count reached), one `log` per call; `wait` is CUDA's run-ahead
    bound only. `init_state` is a phase."""
    t = time.time_ns()
    trainer = Trainer(_fit_config(tmp_path), device="cpu")
    state = trainer.fit()
    assert state.step == 3
    assert [p.name for p in _since(t)] == ["octave.fit.init_state"]
    (trace_file,) = os.listdir(tmp_path)
    with open(tmp_path / trace_file) as f:
        names = Counter(e["name"] for e in json.load(f)["traceEvents"]
                        if str(e.get("name", "")).startswith("octave.fit."))
    assert names == {"octave.fit.call": 4, "octave.fit.next_batch": 4,
                     "octave.fit.call_batch": 3, "octave.fit.step": 3, "octave.fit.log": 3}


def test_fit_loop_trains_as_the_loop_it_replaced():
    """fit's losses and final weights equal those of the loop fit ran before
    its spans (a `for` over the calls, the step run on `call_batch`'s
    output), bit for bit on the CPU."""
    cfg = _fit_config()
    trainer = Trainer(cfg, device="cpu")
    got = []
    base = trainer.step_call

    def tap(st):
        run = base(st)

        def step(s, batch):
            got.append(run(s, batch))
            return got[-1]

        return step

    trainer.step_call = tap
    state = trainer.fit()

    ref = Trainer(cfg, device="cpu")
    ref_state = ref.init_state()
    k = ref.steps_per_call
    batches = ds.batch_iterator(build_dataset(cfg, "train"), cfg.data.batch_size,
                                seed=cfg.train.seed, start=0)
    aug_gen = torch.Generator() if cfg.data.augment else None
    want = []
    for host_batches in iter(lambda: [next(batches) for _ in range(k)], None):
        if ref_state.step >= cfg.train.steps:
            break
        want.append(ref.train_step(ref_state, ref.call_batch(host_batches, ref_state.step,
                                                             aug_gen)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for n in g:
            assert torch.equal(g[n], w[n]), n
    for (n, a), b in zip(state.segmentor.state_dict().items(),
                         ref_state.segmentor.state_dict().values()):
        assert torch.equal(a, b), n


def _one_step(architecture):
    """(Trainer, state, device batch) of an eager CPU step of `architecture`
    at 32², B = 2, both noise layers on."""
    cfg = _fit_config().apply_overrides({"model.architecture": architecture,
                                         "model.instance_noise": "true",
                                         "model.label_noise": "true"})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    host = next(ds.batch_iterator(build_dataset(cfg, "train"), cfg.data.batch_size, seed=1))
    return trainer, state, trainer.call_batch([host], 0)


@pytest.mark.parametrize("architecture, critics", [("parallel_head_gate", ("main", "c")),
                                                   ("unet", ("main",))])
def test_train_step_records_its_spans_per_critic(architecture, critics):
    """Under a profiler one eager step records one `octave.step.segmentor`
    span, holding a generator span per critic, and a critic span per critic
    after it, in the step's order (main, then c)."""
    trainer, state, batch = _one_step(architecture)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(state, batch)
    ev = sorted((e for e in _events(prof) if e[0].startswith("octave.step.")),
                key=lambda e: e[1])
    names = [n for n, _, _ in ev]
    assert names == (["octave.step.segmentor"]
                     + [f"octave.step.generator.{c}" for c in critics]
                     + [f"octave.step.critic.{c}" for c in critics])
    (_, s0, s1), gens = ev[0], ev[1:1 + len(critics)]
    assert all(s0 <= a < b <= s1 for _, a, b in gens)
    assert all(s1 <= a for _, a, _ in ev[1 + len(critics):])


def test_train_step_enters_no_span_without_a_profiler(monkeypatch):
    """With no profiler running the dual-critic step never builds a
    `record_function`, and trains."""
    trainer, state, batch = _one_step("parallel_head_gate")

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    losses = trainer.train_step(state, batch)
    assert state.step == 1 and all(torch.isfinite(v) for v in losses.values())


def test_batch_server_counts_requests_slots_and_waits():
    """A CPU BatchServer's `stats()` count the submissions as requests, the
    k x batch slots of its dispatches (at least the requests), a fill in
    (0, 1] and a non-negative wait; the process counters rise by as much."""
    pred = Predictor.initialize(image_hw=HW, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (*HW, 3), dtype=np.uint8) for _ in range(7)]
    before = profiling.counters()
    with BatchServer(pred, batch=2, image_hw=HW, ks=(1, 2), warmup=False) as srv:
        outs = [f.result(timeout=120) for f in [srv.submit(im) for im in imgs]]
        stats = srv.stats()
    assert len(outs) == 7
    assert stats["requests"] == 7 and stats["slots"] >= 7 and stats["dispatches"] >= 1
    assert stats["slots"] % 2 == 0 and 0 < stats["fill"] <= 1
    assert stats["queue_wait_s"] >= 0 and stats["mean_wait_s"] == pytest.approx(
        stats["queue_wait_s"] / 7)
    after = profiling.counters()
    for name in ("requests", "slots", "dispatches", "queue_wait_s"):
        key = f"batch_server.{name}"
        assert after[key] - before.get(key, 0) == pytest.approx(stats[name]), key
