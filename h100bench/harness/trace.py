"""The traced stretch: device kernels and host spans from `torch.profiler`,
and what the per-layer readers are given."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

Interval = Tuple[str, float, float]  # (name, start s, end s) on the profiler's clock


def _events(prof) -> list:
    """(name, is_device, start s, end s, is_annotation) of every profiled
    event, read straight from the profiler's results (fast: no op tree)."""
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        for ev in results.events():
            start = ev.start_ns() * 1e-9
            out.append((ev.name(), str(ev.device_type()).endswith("CUDA"), start,
                        start + ev.duration_ns() * 1e-9,
                        bool(getattr(ev, "is_user_annotation", lambda: False)())))
        return out
    for ev in prof.events():  # older profilers
        out.append((ev.name, str(ev.device_type).endswith("CUDA"), ev.time_range.start * 1e-6,
                    ev.time_range.end * 1e-6, bool(getattr(ev, "is_user_annotation", False))))
    return out


def union_seconds(intervals) -> float:
    """Seconds covered by at least one (start, end) interval."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Reading:
    """One traced stretch: whole units of work (dispatches, calls) run with
    the profiler on."""

    kernels: List[Interval]  # device kernels and copies
    host: List[Interval]  # host-side events: the benchmark's spans, ops, runtime calls
    window_s: float  # the stretch's length, synchronised at both ends
    units: int  # dispatches or calls in the stretch
    images: int  # images they carried
    config: Dict[str, Any]
    workload: Dict[str, Any]
    t0: float = 0.0  # the stretch's start on the profiler's clock

    @property
    def busy_s(self) -> float:
        return union_seconds((a, b) for _, a, b in self.kernels)

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.kernels if match(n))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self) -> Dict[str, list]:
        """The 10 device operations that took most time, and the idle time
        of the device summed by what the host was doing when each gap began
        (the innermost host event under way), the 10 largest."""
        ops: Dict[str, float] = {}
        for n, a, b in self.kernels:
            ops[n] = ops.get(n, 0.0) + (b - a)
        lo = self.t0
        hi = lo + self.window_s
        host = sorted(self.host, key=lambda e: e[1])
        idle: Dict[str, float] = {}
        for a, b in gaps([(s, e) for _, s, e in self.kernels], lo, hi):
            label = "no host event"
            for n, s, e in host:
                if s > a:
                    break
                if e > a:
                    label = n  # the latest-starting event that covers the gap's start
            idle[label] = idle.get(label, 0.0) + (b - a)
        return {"device_ops": _top(ops), "idle_gaps": _top(idle)}


def _top(seconds: Dict[str, float], n: int = 10) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]


class Stretch:
    """A traced stretch begun and ended around whole units of work:
    `start()`, the work, then `stop(units, images)` -> Reading. Both ends
    synchronise the device."""

    def __init__(self, config, workload):
        self.config, self.workload = config, workload

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile as torch_profile

        torch.cuda.synchronize()
        self.prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function("h100bench.stretch")
        self.span.__enter__()
        self.t = time.perf_counter()

    def stop(self, units: int, images: int) -> Reading:
        import torch

        torch.cuda.synchronize()
        window = time.perf_counter() - self.t
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        events = _events(self.prof)
        kernels = [(n, a, b) for n, dev, a, b, ann in events if dev and not ann
                   and not n.startswith("Activity")]
        host = [(n, a, b) for n, dev, a, b, ann in events if not dev]
        stretch = next(((a, b) for n, a, b in host if n == "h100bench.stretch"), None)
        t0 = stretch[0] if stretch else min((a for _, a, _ in kernels), default=0.0)
        return Reading(kernels, host, window, units, images, self.config, self.workload, t0)

