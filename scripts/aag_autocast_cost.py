#!/usr/bin/env python3
"""What gating in the autocast dtype costs or saves the bf16 train step, on
one NVIDIA GPU. Run from the repository root on a machine with CUDA:

    python3 scripts/aag_autocast_cost.py [--pairs 10]

Under autocast the gate (`models/segmentor.py::AdversarialAttentionGate`)
has the AAG kernel round its float32 input to the autocast dtype as it
loads it, write x*mask in that dtype and y_hat in float32, and compute the
backward from the float32 input ("in bf16"). Before, the gate read its
float32 input as it came and wrote both outputs in float32 ("as it comes").
This runs the default Config's bf16 step (`unet`, 304², B = 8, critic of
depth 4, noise on) on one Trainer and one batch, both ways in alternating
pairs (in bf16 first in even pairs, as it comes first in odd ones): per
turn the median step ms of 10 steps (host clock, synchronised) and the peak
device memory of those steps; then one profiled step each way, with the
device time of the AAG kernel beside its byte bound (3.35 TB/s), of every
cast or copy kernel and of the whole step. The card's name and power limit
are printed first.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from octave_tpu_torch.data import datasets as ds  # noqa: E402
from octave_tpu_torch.models import segmentor as seg_mod  # noqa: E402
from octave_tpu_torch.ops.kernels import triton_build_dir  # noqa: E402
from octave_tpu_torch.train.trainer import Trainer, build_dataset  # noqa: E402
from octave_tpu_torch.utils.config import Config  # noqa: E402

IN_BF16 = seg_mod.AdversarialAttentionGate.forward
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, as chip_smoke.py
# (pixels, C) of the five gates of a 304², B = 8 step; K = 2 classes
GATES = [(8 * hw * hw, c) for hw, c in ((304, 32), (152, 64), (76, 256), (38, 512),
                                        (19, 1024))]
# bytes per element of x*mask: bf16 in bf16, float32 as it comes
OUT_ITEMSIZE = {"in bf16": 2, "as it comes": 4}


def bound_ms(out_itemsize: int) -> float:
    """Least ms of the five gates' forwards: float32 x read once, x*mask
    written in `out_itemsize` bytes and float32 y_hat once (W, b beside)."""
    nbytes = sum(n * c * (4 + out_itemsize) + n * 2 * 4 + (c * 2 + 2) * 4 for n, c in GATES)
    return nbytes / HBM_BYTES_PER_S * 1e3


def as_it_comes(self, x):
    """The gate reading its float32 input as it comes (both outputs float32)."""
    k = self.conv1.out_channels
    out, yhat = seg_mod.fused_aag(seg_mod.nhwc(x), self.conv1.weight.view(k, -1).t(),
                                  self.conv1.bias)
    return seg_mod.nchw(out), yhat


VARIANTS = {"in bf16": IN_BF16, "as it comes": as_it_comes}


def turn(tr, state, batch, name):
    seg_mod.AdversarialAttentionGate.forward = VARIANTS[name]
    tr.train_step(state, batch)  # the switch's first step is not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        tr.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2**30


def profiled(tr, state, batch, name):
    """Device ms of one step: (AAG kernel, cast and copy kernels, all)."""
    seg_mod.AdversarialAttentionGate.forward = VARIANTS[name]
    tr.train_step(state, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tr.train_step(state, batch)
        torch.cuda.synchronize()
    aag = cast = total = 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        total += us
        if "aag_fwd_kernel" in ev.key:
            aag += us
        elif "copy" in ev.key.lower() or "cast" in ev.key.lower():
            cast += us
    return aag / 1e3, cast / 1e3, total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("aag_autocast_cost: needs a CUDA device", file=sys.stderr)
        return 1
    triton_build_dir()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = Config().apply_overrides({"data.synthetic_n": "8", "train.compute_dtype": "bfloat16",
                                    "train.eval_every": "0", "train.log_every": "0"})
    tr = Trainer(cfg, device="cuda")
    state = tr.init_state()
    batch = tr.device_batch(next(ds.batch_iterator(build_dataset(cfg), 8, seed=0)))
    try:
        for name in VARIANTS:  # warm-up: kernels built, cuDNN's choices made
            turn(tr, state, batch, name)
        ms = {name: [] for name in VARIANTS}
        for i in range(args.pairs):
            order = ("in bf16", "as it comes") if i % 2 == 0 else ("as it comes", "in bf16")
            for name in order:
                t, gib = turn(tr, state, batch, name)
                ms[name].append(t)
                print(f"pair {i} bf16 step 304², B=8, gate {name}: {t:.1f} ms, "
                      f"peak {gib:.3f} GiB", flush=True)
        diffs = [a - b for a, b in zip(ms["in bf16"], ms["as it comes"])]
        for name, v in ms.items():
            print(f"gate {name}: median of {len(v)} turns {statistics.median(v):.1f} ms, "
                  f"min {min(v):.1f}, max {max(v):.1f}", flush=True)
        print(f"in bf16 - as it comes, per pair: median {statistics.median(diffs):+.1f} ms, "
              f"{sum(d < 0 for d in diffs)} of {len(diffs)} pairs faster in bf16", flush=True)
        for name in VARIANTS:
            aag, cast, total = profiled(tr, state, batch, name)
            bound = bound_ms(OUT_ITEMSIZE[name])
            print(f"profiled step, gate {name}: AAG kernel {aag:.4f} ms (5 launches; byte "
                  f"bound {bound:.4f} ms, {100 * bound / aag:.1f}%), cast and copy kernels "
                  f"{cast:.4f} ms, device total {total:.2f} ms", flush=True)
    finally:
        seg_mod.AdversarialAttentionGate.forward = IN_BF16
    return 0


if __name__ == "__main__":
    sys.exit(main())
