#!/usr/bin/env python3
"""The gradients that reach the attention pyramid in the adversarial train
step under autocast, on one NVIDIA GPU. Run from the repository root on a
machine with CUDA:

    python3 scripts/f16_pyramid_grad.py

The default Config (`unet`, 304², B = 8, critic of depth 4, noise off) runs
8 steps on one synthetic batch in three settings: bf16 and float16 autocast
with the gate's y_hat (the pyramid) kept in float32, as the port's train path
keeps it (`models/segmentor.py::AdversarialAttentionGate`), and float16 with
y_hat in float16, the gate input's dtype. Each step prints its losses, the
largest |gradient| that reaches each pyramid level, the segmentor's
parameter gradients that are not finite, and stops a setting once a
parameter is no longer finite. The card's name and power limit are printed
first.
"""
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from octave_tpu_torch.data import datasets as ds  # noqa: E402
from octave_tpu_torch.models import segmentor as seg_mod  # noqa: E402
from octave_tpu_torch.ops.kernels import triton_build_dir  # noqa: E402
from octave_tpu_torch.train import steps  # noqa: E402
from octave_tpu_torch.train.trainer import Trainer, build_dataset  # noqa: E402
from octave_tpu_torch.utils.config import Config  # noqa: E402

STEPS = 8


def run(dtype: str, yhat_float32: bool) -> None:
    over = {"data.synthetic_n": "8", "data.batch_size": "8", "model.instance_noise": "false",
            "model.label_noise": "false", "train.eval_every": "0", "train.log_every": "0",
            "train.compute_dtype": dtype}
    tr = Trainer(Config().apply_overrides(over), device="cuda")
    state = tr.init_state()
    batch = tr.device_batch(next(ds.batch_iterator(build_dataset(tr.cfg), 8, seed=0)))
    seen = {}
    adapt, aag = steps.adapt_segmentor_output, seg_mod.fused_aag

    def watched(out):
        pyramids, agg_maps = adapt(out)
        for i, t in enumerate(pyramids[0]):
            t.register_hook(lambda g, i=i: seen.__setitem__(i, float(g.float().abs().max())))
        return pyramids, agg_maps

    steps.adapt_segmentor_output = watched
    if not yhat_float32:
        seg_mod.fused_aag = lambda x, w, b, autocast_dtype=None: aag(
            x if autocast_dtype is None else x.to(autocast_dtype), w, b)
    try:
        for i in range(STEPS):
            seen.clear()
            losses = tr.train_step(state, batch)
            torch.cuda.synchronize()
            bad = sum(not bool(torch.isfinite(p.grad).all())
                      for p in state.segmentor.parameters() if p.grad is not None)
            print(f"{dtype}, y_hat {'float32' if yhat_float32 else dtype}, step {i + 1}: "
                  + ", ".join(f"{k} {float(v):.5f}" for k, v in losses.items())
                  + "; max |grad| at pyramid levels 0-4 "
                  + ", ".join(f"{seen[j]:.3g}" for j in sorted(seen))
                  + f"; non-finite segmentor gradients {bad}", flush=True)
            if not all(bool(torch.isfinite(p).all()) for p in state.segmentor.parameters()):
                print("  segmentor parameters are no longer finite: stop", flush=True)
                break
    finally:
        steps.adapt_segmentor_output, seg_mod.fused_aag = adapt, aag


def main() -> int:
    if not torch.cuda.is_available():
        print("f16_pyramid_grad: needs a CUDA device", file=sys.stderr)
        return 1
    triton_build_dir()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for dtype, yhat_float32 in (("bfloat16", True), ("float16", True), ("float16", False)):
        run(dtype, yhat_float32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
