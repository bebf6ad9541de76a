"""Tracing helpers: the port of `octave_tpu/utils/profiling.py` (:12-68) on
`torch.profiler`. `StepTimer` lives in `utils/logging.py`."""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator, Optional

import torch


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


def annotate(name: str):
    """Decorator: the function's calls show as a named region in the trace."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def nan_debug(enable: bool = True) -> None:
    """Autograd's anomaly detection: a backward that produces NaN raises and
    names the forward operation that made it."""
    torch.autograd.set_detect_anomaly(enable)
