"""Tracing of the port: the Chrome-trace exporter (the port of
`octave_tpu/utils/profiling.py` :12-68 on `torch.profiler`), spans at the
port's layer boundaries, set-up phases and named counters.
`StepTimer` lives in `utils/logging.py`.

* `span(name)`: a hot-path span. It is a `torch.profiler.record_function`
  while a profiler records on the calling thread, and a shared no-op
  otherwise (0.5 us against `record_function`'s 10-13 us on a CPU with no
  profiler running). Spans land among the profiler's host events, on the
  clock of its device kernels, so a profile of any kind (`trace`,
  `train.profile_dir`, the benchmark's traced stretch) shows them. A span
  inside a function that a CUDA graph captures (the train step's) shows
  only where that function's Python runs, eagerly or at the capture: a
  replay runs no Python.
* `phase(name)`: a set-up span that is always recorded, into a bounded
  in-memory list (`phases()`), stamped in Unix-epoch nanoseconds
  (`time.time_ns()`, the clock of the profiler's events) with
  `torch.cuda.memory_reserved()` at both ends; it opens a `span` too.
* `count(name, n)` / `counters()`: one lock-guarded registry of named
  counts for the process (the kernels' launch counts, graph captures,
  `serve.BatchServer`'s requests).

Names are `octave.<layer>.<what>` for spans and phases.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

# `torch.profiler.record_function` costs ~10 us even with no profiler
# running; this reads the calling thread's profiler state only
_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region on the host and, where there is one, the
    GPU, and write a Chrome trace (chrome://tracing, Perfetto) into
    `log_dir`; a no-op without a directory."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{int(time.time())}_{os.getpid()}.json"))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager: `name` as a region of the profile when a profiler
    records on this thread (`attrs` as its arguments), else a no-op."""
    if not _profiler_enabled():
        return _NO_SPAN
    args = ", ".join(f"{k}={v}" for k, v in attrs.items()) if attrs else None
    return torch.profiler.record_function(name, args)


class Phase(NamedTuple):
    """One recorded set-up phase; times in Unix-epoch ns (`time.time_ns()`),
    memory as `torch.cuda.memory_reserved()` (0 where CUDA is not in use)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the phase open around it on its thread, if any
    reserved_start: int
    reserved_end: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


# a process records about ten; a long-lived server that captures new shapes
# adds two per shape, so the oldest are dropped past MAX_PHASES
MAX_PHASES = 1024
_PHASES: deque = deque(maxlen=MAX_PHASES)
_PHASE_LOCK = threading.Lock()
_OPEN = threading.local()  # .names: the phases open on this thread, innermost last


def _reserved() -> int:
    return torch.cuda.memory_reserved() if torch.cuda.is_initialized() else 0


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Record the enclosed set-up step as a `Phase` (also when it raises),
    inside a `span` of the same name."""
    names = _OPEN.__dict__.setdefault("names", [])
    parent = names[-1] if names else None
    reserved, start = _reserved(), time.time_ns()
    names.append(name)
    try:
        with span(name):
            yield
    finally:
        names.pop()
        record = Phase(name, start, time.time_ns(), parent, reserved, _reserved())
        with _PHASE_LOCK:
            _PHASES.append(record)


def phases() -> List[Phase]:
    """The recorded phases, oldest first (at most MAX_PHASES)."""
    with _PHASE_LOCK:
        return list(_PHASES)


# the counters; reentrant, so that `ops.kernels` can update several counts
# (a capture's tally) as one step under it
COUNTER_LOCK = threading.RLock()
_COUNTERS: Dict[str, float] = {}


def count(name: str, n: float = 1) -> None:
    """Add n to the counter `name` (created at 0)."""
    with COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter(name: str) -> float:
    with COUNTER_LOCK:
        return _COUNTERS.get(name, 0)


def set_counter(name: str, value: float) -> None:
    with COUNTER_LOCK:
        _COUNTERS[name] = value


def counters(reset: bool = False) -> Dict[str, float]:
    """{name: count} of every counter; with `reset`, zero them in the same
    critical section."""
    with COUNTER_LOCK:
        out = dict(_COUNTERS)
        if reset:
            for name in _COUNTERS:
                _COUNTERS[name] = 0
        return out
