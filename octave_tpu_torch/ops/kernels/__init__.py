"""Hand-written Hopper kernels of the port, by two routes:

  * Triton, for the Pallas kernels of octave_tpu (`aag`, `decoder_epilogue`)
    and for the served model's folded batch norms with their residual joins
    and ReLUs (`bn_act`, which XLA fuses in the JAX package): Triton is
    imported only inside the functions that launch a kernel;
  * CUDA C++ for sm_90a (`int8_conv`, the int8 serving conv, which the JAX
    package leaves to XLA): sources in `csrc/`, compiled by nvcc at first
    use and bound with ctypes (`cuda_build`).

A host without a GPU, Triton or nvcc imports every module here and runs the
plain PyTorch versions on CPU tensors; on a CUDA tensor each wrapper
launches its kernel or raises.
"""
from __future__ import annotations

import contextlib
import functools
import os
from pathlib import Path
from typing import Optional

import torch

from octave_tpu_torch.utils import profiling

# Triton writes its compiled kernels here (listed in .gitignore), so a fresh
# checkout builds every kernel from this package's sources.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "triton"


def triton_build_dir() -> Path:
    """Point Triton's cache at BUILD_DIR; call before the first `import triton`."""
    if os.environ.get("TRITON_CACHE_DIR") != str(BUILD_DIR) or not BUILD_DIR.is_dir():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR)
    return BUILD_DIR


# Each kernel wrapper is a `Counted`, whose `launches` is the counter
# `launches.<name>` of `utils.profiling`'s registry, raised once where it
# launches its kernel; a `Counter` alone counts what a launch chose
# (`int8_conv.path.<path>`), the same way. A serving worker thread launches while another thread
# reads or zeroes the counts, so all of them go through the registry's lock.
# Inside `record_launches` (a CUDA-graph capture, which records kernels
# without running them) a launch goes to the capture's tally instead, and
# each replay adds that tally (`add_launches`).
_COUNTED: dict = {}
_TALLY: Optional[dict] = None


class Counter:
    """A counter of `utils.profiling.counters()` that `count_launch` raises
    (into a capture's tally inside `record_launches`); its `launches` reads
    and sets it."""

    def __init__(self, counter: str):
        self.counter = counter
        profiling.set_counter(counter, 0)

    @property
    def launches(self):
        return profiling.counter(self.counter)

    @launches.setter
    def launches(self, n) -> None:
        profiling.set_counter(self.counter, n)


class Counted(Counter):
    """A kernel wrapper: calls `fn`, and reads and sets its `launches` in
    the counter `launches.<name>` of `utils.profiling.counters()`."""

    def __init__(self, name: str, fn):
        functools.update_wrapper(self, fn)
        self.fn = fn
        super().__init__(f"launches.{name}")

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def register_counter(name: str, wrapper) -> Counted:
    """The kernel wrapper as a `Counted` whose launches start at 0 and show
    in `launch_counts()` under `name`."""
    counted = Counted(name, wrapper)
    with profiling.COUNTER_LOCK:
        _COUNTED[name] = counted
    return counted


def count_launch(wrapper) -> None:
    with profiling.COUNTER_LOCK:
        if _TALLY is not None:
            _TALLY[wrapper] = _TALLY.get(wrapper, 0) + 1
        else:
            wrapper.launches += 1


@contextlib.contextmanager
def record_launches():
    """Count the launches made inside into the yielded {wrapper: launches}
    instead of the wrappers' counts (on every thread: a capture's backward
    runs on autograd's)."""
    global _TALLY
    tally: dict = {}
    with profiling.COUNTER_LOCK:
        if _TALLY is not None:
            raise RuntimeError("launches are already being recorded")
        _TALLY = tally
    try:
        yield tally
    finally:
        with profiling.COUNTER_LOCK:
            _TALLY = None


def add_launches(tally: dict) -> None:
    """Add a recorded tally to the wrappers' counts (one replay's launches)."""
    with profiling.COUNTER_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n


def launch_counts(reset: bool = False) -> dict:
    """{kernel name: launches since the last reset} of every registered
    wrapper; with `reset`, zero them in the same critical section."""
    with profiling.COUNTER_LOCK:
        counts = {name: w.launches for name, w in _COUNTED.items()}
        if reset:
            for w in _COUNTED.values():
                w.launches = 0
        return counts


def check_nhwc(name: str, t: torch.Tensor, ndim: int, device: torch.device,
               dtypes: tuple = (torch.float32, torch.bfloat16, torch.float16)) -> None:
    """Raise unless `t` is a contiguous tensor of rank `ndim` on `device`
    with a dtype in `dtypes`."""
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (NHWC, i.e. channels_last NCHW "
                         f"permuted to NHWC); strides {t.stride()}")


# Kernel against its plain version: (out, y_hat) tolerances as (atol, rtol).
# float32: those of tests/test_pallas_kernels.py, whose cases have C <= 64.
# Each logit is a float32 sum of C terms whose rounding noise grows as
# sqrt(C), so above C = 64 the float32 atol is scaled by sqrt(C / 64) (x4 at
# C = 1024; an H100 run found the AAG's y_hat 1.01e-6 off at C = 256).
# bfloat16: both sides compute in float32 and round once, so they may differ
# by one bf16 ulp (rtol 2^-7) where a value sits on a rounding boundary.
# float16: the same single rounding of float32 values, so one float16 ulp
# (rtol 2^-10); the atol is the bf16 rows', for values near zero whose
# float32 sums differ in order between the two sides.
_TOL = {
    ("aag", torch.float32): ((1e-5, 0.0), (1e-6, 0.0)),
    ("decoder_epilogue", torch.float32): ((2e-5, 0.0), (1e-5, 0.0)),
    ("aag", torch.bfloat16): ((1e-3, 2**-7), (1e-3, 2**-7)),
    ("decoder_epilogue", torch.bfloat16): ((1e-3, 2**-7), (1e-3, 2**-7)),
    ("aag", torch.float16): ((1e-3, 2**-10), (1e-3, 2**-10)),
    ("decoder_epilogue", torch.float16): ((1e-3, 2**-10), (1e-3, 2**-10)),
}


def kernel_tolerance(kernel: str, dtype: torch.dtype, c: int):
    """((atol, rtol) of out, (atol, rtol) of y_hat) for `kernel` at width C."""
    scale = max(1.0, (c / 64) ** 0.5) if dtype == torch.float32 else 1.0
    return tuple((atol * scale, rtol) for atol, rtol in _TOL[(kernel, dtype)])


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pow2_tile(c: int, elems: int) -> tuple[int, int]:
    """(rows, BLOCK_C) for a [rows, BLOCK_C] register tile of about `elems`
    values: BLOCK_C is the next power of two >= c."""
    block_c = next_pow2(c)
    return max(1, elems // block_c), block_c
