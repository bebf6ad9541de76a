"""Serving benchmark: 304x304 en-face inference throughput on one GPU; the
port of the repository's root `bench.py` (`cli bench`).

    python -m octave_tpu_torch.bench        (or: python -m octave_tpu_torch.cli bench)

Prints ONE JSON line with the JAX bench's keys but `vs_baseline` (a ratio to
a TPU target, meaningless here), and the card it ran on:
  {"metric": ..., "value": img/s, "unit": "images/sec/chip",
   "per_call_img_s": ..., "int8_mask_agreement": ..., "device": "<name>, <power limit>"}

The configuration is the JAX package's production serving path
(`bench.py:1-35` there):
  * the committed trained bf16 weights, `benchmarks/weights304.npz` (its
    shards), read by `utils/checkpoint.py::load_weights_npz` and mapped by
    `utils/convert.py::from_jax_variables`. The JAX bench's second source, an
    orbax TrainState dump under `benchmarks/ckpt304`, is local to a TPU host
    and has no format in this package, so it is not read here; missing
    weights raise, and no random initialisation stands in for them;
  * folded BN, bf16, the fused decoder epilogue (`serve.Predictor`);
  * an int8 post-training-quantised decoder with prepacked weights,
    calibrated on 64 vessel phantoms, with the decoder's grouped convs
    dense-lowered (`dense_groups="decoder"`);
  * an agreement gate: the int8 masks must agree with the bf16 Predictor's
    on >= 0.99 of the phantoms' pixels (argmax), else the bench serves bf16
    and the metric's label says so, with the agreement;
  * B = 256 per forward, timed per call (8 calls, the first 2 excluded,
    median) and as k = 4 batches in one `predict_many_device` dispatch (2
    warm-ups, median of 5), on inputs uploaded once in the compute dtype;
    each timed call reads back one pixel's probabilities, which must be
    finite and sum to 1. On CUDA the two excluded calls of each are the
    Predictor's eager warm-up and its graph capture, so every timed call
    is one graph replay, as every timed JAX call runs the compiled program.
A failure anywhere raises: the JAX bench's fallbacks (to random weights, to
bf16 when the int8 build fails, to per-call timing when the dispatch fails)
are not ported, and the record has no `degraded` key.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from octave_tpu_torch.data.datasets import SyntheticOcta
from octave_tpu_torch.serve import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "benchmarks", "weights304.npz")
AGREEMENT_GATE = 0.99  # int8 against bf16 argmax masks, the JAX bench's
CALIBRATION_IMAGES = 64


def load_trained_variables():
    """The committed trained serving weights as the port's reference-named
    state dict; FileNotFoundError when they are missing."""
    from octave_tpu_torch.utils.checkpoint import load_weights_npz
    from octave_tpu_torch.utils.convert import from_jax_variables

    return from_jax_variables(load_weights_npz(WEIGHTS))


def phantom_batch(batch: int, hw: int) -> np.ndarray:
    """(batch, hw, hw, 3) float32 vessel phantoms in [0, 1]: min(batch, 64)
    distinct SyntheticOcta images (seed 11) tiled to `batch`, as the JAX
    bench makes them. int8 calibration and the agreement gate mean something
    only on vessel-like inputs."""
    n_unique = min(batch, CALIBRATION_IMAGES)
    ds = SyntheticOcta(size=(hw, hw), n=n_unique, seed=11)
    imgs = np.stack([ds[i].image for i in range(n_unique)])
    x = (imgs.astype(np.float32) / 255.0)[..., None].repeat(3, axis=-1)
    return np.tile(x, (-(-batch // n_unique), 1, 1, 1))[:batch]


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" off
    CUDA)."""
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    uuid = torch.cuda.get_device_properties(index).uuid
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(index)}, power limit not read ({e})"


def mask_agreement(pred_a: Predictor, pred_b: Predictor, x) -> float:
    """Share of pixels whose argmax class two Predictors agree on."""
    return float((pred_a(x).argmax(-1) == pred_b(x).argmax(-1)).mean())


def median_dispatch_s(pred: Predictor, stack: torch.Tensor, calls: int, warmup: int) -> float:
    """Median seconds of `pred.predict_many_device(stack)` on a (k, B, ...)
    device stack, over `calls` calls less the first `warmup`. Each call ends
    when one pixel's class probabilities are back on the host, and raises
    unless they are finite and sum to 1."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        tap = pred.predict_many_device(stack).tensor[0, 0, 0, 0, :].cpu().numpy()
        times.append(time.perf_counter() - t0)
        if not (np.isfinite(tap).all() and abs(float(tap.sum()) - 1.0) < 1e-2):
            raise RuntimeError(f"bench: bad output probabilities {tap}")
    return statistics.median(times[warmup:])


class BenchRun(NamedTuple):
    record: dict
    served: Predictor  # the int8 Predictor, or bf16 below the gate
    int8: Predictor
    bf16: Predictor
    images: np.ndarray  # the float32 host batch


def main(batch: int = 256, hw: int = 304, k: int = 4,
         device: Optional[str | torch.device] = None) -> BenchRun:
    """Build, gate and time the serving configuration; print its record as
    one JSON line. `device` is CUDA by default; the smaller sizes and the CPU
    are for tests."""
    x = phantom_batch(batch, hw)
    weights = load_trained_variables()
    kw = {} if device is None else {"device": device}
    calibration = x[:CALIBRATION_IMAGES]
    int8 = Predictor(weights, int8_decoder=True, calibration_batches=[calibration],
                     dense_groups="decoder", **kw)
    bf16 = Predictor(weights, **kw)
    agreement = mask_agreement(int8, bf16, calibration)
    if agreement >= AGREEMENT_GATE:
        pred, label = int8, "bf16 + int8 dense-lowered decoder (prepacked)"
    else:
        print(f"int8/bf16 mask agreement {agreement:.4f} < {AGREEMENT_GATE} - serving bf16",
              file=sys.stderr)
        pred, label = bf16, f"bf16 (int8 agreement gate {agreement:.4f})"

    xs = torch.from_numpy(x).to(pred.device, pred.dtype)  # uploaded once
    per_call = median_dispatch_s(pred, xs[None], calls=8, warmup=2)
    xk = xs.unsqueeze(0).expand(k, *xs.shape).contiguous()
    dt = median_dispatch_s(pred, xk, calls=7, warmup=2)
    record = {
        "metric": f"{hw}x{hw} en-face inference images/sec/chip (ResnestUNet {label}, "
                  "aggregated-dispatch serving path, trained weights304.npz)",
        "value": round(batch * k / dt, 2),
        "unit": "images/sec/chip",
        "per_call_img_s": round(batch / per_call, 2),
        "int8_mask_agreement": round(agreement, 5),
        "device": device_label(pred.device),
    }
    print(json.dumps(record), flush=True)
    return BenchRun(record, pred, int8, bf16, x)


if __name__ == "__main__":
    main()
