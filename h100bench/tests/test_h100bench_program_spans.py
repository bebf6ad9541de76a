"""The readers of the program's own spans and phases, on hand-made traced
stretches and phase lists: clipping at the stretch's ends, waits taken out,
idle gaps put down to the innermost program span (the benchmark's spans and
the runtime's calls ignored), set-up phases read before the stretch as self
times, and nothing read where the program records nothing."""
import json
import os

import pytest

from conftest import BENCH, ROOT

T0 = 1_700_000_000.0  # the stretch's start, Unix-epoch seconds (the profiler's clock)


def _readers(cell_name):
    from harness import cell

    return cell.load(ROOT, cell_name).readers


def _reading(kernels=(), host=(), window_s=0.6, units=2, t0=T0):
    """A stretch of `window_s` from t0; intervals given relative to t0."""
    from harness.trace import Reading

    cfg = json.load(open(os.path.join(BENCH, "configs", "octave-unet304-int8-serve.json")))
    shift = lambda evs: [(n, t0 + a, t0 + b) for n, a, b in evs]  # noqa: E731
    return Reading(kernels=shift(kernels), host=shift(host), window_s=window_s, units=units,
                   images=units * 256, config=cfg, workload={"batch": 256}, t0=t0)


def _phase(name, start_s, end_s, reserved=(0, 0), parent=None):
    from octave_tpu_torch.utils.profiling import Phase

    return Phase(name, int((T0 + start_s) * 1e9), int((T0 + end_s) * 1e9), parent, *reserved)


def test_host_busy_bulk_clips_and_takes_out_the_wait():
    read = _readers("serve-int8-bulk-b256")["host_busy.bulk"].read
    r = _reading(host=[
        ("h100bench.stretch", 0.0, 0.6),
        ("octave.predictor.dispatch", -0.05, 0.01),  # begun before the stretch: 0.01
        ("cudaGraphLaunch", 0.002, 0.004),
        ("octave.predictor.result", 0.20, 0.30),
        ("octave.predictor.wait", 0.21, 0.29),  # inside the result: 0.02 left
        ("cudaEventSynchronize", 0.21, 0.29),
        ("octave.predictor.dispatch", 0.30, 0.31),
        ("octave.predictor.result", 0.58, 0.65),  # runs past the stretch: 0.02
        ("octave.predictor.wait", 0.59, 0.64),  # 0.01 of it inside
    ])
    assert read(r) == pytest.approx(100 * (0.01 + 0.02 + 0.01 + 0.01) / 0.6, rel=1e-4)
    assert read(_reading(host=[("h100bench.stretch", 0.0, 0.6),
                               ("cudaEventSynchronize", 0.1, 0.5)])) is None


def test_host_busy_train_counts_the_first_call_from_its_children():
    read = _readers("train-adv-b8-k1")["host_busy.train"].read
    r = _reading(host=[
        # the call under way at the stretch's start: its span began before
        # the profiler and was not recorded; its children after the start were
        ("h100bench.call_batch", 0.0, 0.04),
        ("octave.fit.call_batch", 0.001, 0.04),
        ("octave.fit.step", 0.04, 0.05),
        ("octave.fit.wait", 0.05, 0.09),
        ("octave.fit.log", 0.09, 0.1),
        # a whole call
        ("octave.fit.call", 0.1, 0.3),
        ("octave.fit.next_batch", 0.1, 0.11),
        ("octave.fit.call_batch", 0.11, 0.15),
        ("octave.fit.step", 0.15, 0.16),
        ("octave.fit.wait", 0.16, 0.29),
        ("cudaEventSynchronize", 0.16, 0.29),
        ("octave.fit.log", 0.29, 0.3),
        # the call at whose call_batch the stretch ends
        ("octave.fit.call", 0.3, 0.7),
        ("octave.fit.next_batch", 0.3, 0.31),
    ], window_s=0.32)
    first = 0.039 + 0.01 + 0.01
    whole = 0.2 - 0.13
    last = 0.32 - 0.3
    assert read(r) == pytest.approx(100 * (first + whole + last) / 0.32, rel=1e-4)
    assert read(_reading(host=[("h100bench.step", 0.0, 0.3)])) is None


def test_idle_data_ms_puts_gaps_down_to_the_innermost_program_span():
    read = _readers("train-adv-b8-k1")["idle_data_ms.train"].read
    kernels = [("k", 0.0, 0.1), ("k", 0.104, 0.2), ("k", 0.23, 0.3), ("k", 0.31, 0.4),
               ("Memcpy HtoD", 0.402, 0.403), ("k", 0.405, 0.5)]
    host = [
        ("octave.fit.call", 0.0, 0.2),
        ("octave.fit.next_batch", 0.09, 0.1),  # ends where the gap at 0.1 begins: not its
        ("h100bench.call_batch", 0.1, 0.15),
        ("octave.fit.call_batch", 0.1, 0.15),  # the gap at 0.1 starts here: 4 ms
        ("cudaMemcpyAsync", 0.1, 0.101),  # started later, but not the program's
        ("octave.fit.step", 0.15, 0.19),
        ("octave.fit.call", 0.2, 0.45),
        ("octave.fit.next_batch", 0.2, 0.25),  # the gap 0.2-0.23 (30 ms) begins here
        ("octave.fit.wait", 0.25, 0.35),  # the gap 0.3-0.31 begins in the wait
        ("h100bench.step", 0.35, 0.41),
        ("octave.fit.call_batch", 0.4, 0.41),  # gaps 0.4-0.402, 0.403-0.405: 4 ms
    ]
    r = _reading(kernels=kernels, host=host, window_s=0.52, units=2)
    # and the stretch's tail 0.5-0.52 falls in no program span
    assert read(r) == pytest.approx(1e3 * (0.004 + 0.03 + 0.002 + 0.002) / 2, rel=1e-4)
    assert read(_reading(kernels=kernels, host=[("octave.fit.wait", 0.0, 0.5)])) is None
    assert read(_reading(kernels=kernels, host=host, units=0)) is None


def test_phase_readers_read_setup_before_the_stretch(monkeypatch):
    from octave_tpu_torch.utils import profiling

    gib = 2 ** 30
    phases = [
        _phase("octave.predictor.build", -30.0, -20.0, (0, 14 * gib)),
        _phase("octave.kernels.build", -19.5, -19.0, (14 * gib, 14 * gib),
               parent="octave.quant.calibrate"),
        _phase("octave.quant.calibrate", -20.0, -17.5, (14 * gib, 20 * gib)),
        _phase("octave.quant.quantize", -17.5, -17.0),
        _phase("octave.graph.warmup", -16.0, -14.5),
        _phase("octave.kernels.build", -15.9, -15.6, parent="octave.graph.warmup"),
        _phase("octave.graph.capture", -14.5, -13.75),
        _phase("octave.graph.capture", 0.1, 0.2),  # in the stretch: not set-up
    ]
    monkeypatch.setattr(profiling, "phases", lambda: list(phases))
    bulk, train = _readers("serve-int8-bulk-b256"), _readers("train-adv-b8-k1")
    r = _reading()
    # self times: nvcc's build inside a phase is not the phase's own
    assert bulk["calibrate_s.bulk"].read(r) == pytest.approx(2.0, rel=1e-4)
    assert bulk["calibrate_gib.bulk"].read(r) == pytest.approx(6.0, rel=1e-4)
    assert bulk["capture_s.bulk"].read(r) == pytest.approx(1.95, rel=1e-4)
    assert train["capture_s.train"].read(r) == pytest.approx(1.95, rel=1e-4)
    # a run whose program recorded none of them, or records no phases at all
    phases[:] = [_phase("octave.fit.init_state", -5.0, -4.0)]
    for read in (bulk["calibrate_s.bulk"].read, bulk["calibrate_gib.bulk"].read,
                 bulk["capture_s.bulk"].read, train["capture_s.train"].read):
        assert read(r) is None
    monkeypatch.delattr(profiling, "phases")
    assert bulk["capture_s.bulk"].read(r) is None
