"""The check of the dual-decoder training cells: `harness.training`'s check
with the dual segmentor and both critics (`reference.dual`), and three more
numbers: the `_c` branch's first moments and the "c" critic's changes, so
that a fault confined to the second head or the second critic shows, and
the first step's logits of both heads, a number over every pixel that the
step below the configuration's precision moves where the losses' scalars
and the leaves' medians do not."""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from harness import training
from harness.cell import Check

# the `_c` branch's leaves of the segmentor, the "c" critic's leaves
SEG_C = ("seg/upsampling_1_c.", "seg/decoder_1_c.", "seg/aag_1_c.", "seg/upsampling_0_c.",
         "seg/decoder_0_c.", "seg/aag_0_c.", "seg/fc_c.")
CRITIC_C = ("critic/c.",)


def depths(cfg) -> Dict[str, int]:
    return {name: c["depth"] for name, c in cfg["critic"].items()}


def seeded_weights(run, device):
    """The dual segmentor's and both critics' seeded float32 weights (the
    critics' under `main.` and `c.`)."""
    import torch

    from reference.dual import critics_spec, dual_segmentor_spec
    from reference.model import make_params

    cfg = run.config
    hw = tuple(cfg["program_config"]["data"]["image_size"])
    gen = torch.Generator(device=device).manual_seed(run.seed)
    seg = make_params(dual_segmentor_spec(), gen, device)
    crit = make_params(critics_spec(hw, depths(cfg), cfg["critic"]["main"]["filters"]), gen,
                       device)
    return seg, crit


def reference_run(run, conf, precision=None, half_batch=False, fault=None):
    """`harness.training.reference_run` on the dual decoders and both
    critics, and the first step's logits of both heads (heads, images,
    NHWC); `fault` is one of `reference.dual.DualTrainer`'s."""
    import torch

    from harness.serving import reference_precision
    from reference.dual import DualTrainer
    from reference.model import Precision
    from reference.phantoms import batch_indices, synthetic_octa
    from reference.train import prepare

    wl, k = run.workload, conf.train.steps_per_call
    steps = wl["compared_calls"] * k
    device = torch.device(run.device)
    seg, crit = seeded_weights(run, device)
    init = {**{"seg/" + n: v.clone() for n, v in seg.items()},
            **{"critic/" + n: v.clone() for n, v in crit.items()}}
    size = tuple(conf.data.image_size)
    idx = batch_indices(conf.data.synthetic_n, conf.data.batch_size, conf.train.seed, steps)
    samples = {int(i): synthetic_octa(int(i), conf.train.seed, size) for i in np.unique(idx)}
    real_dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        conf.train.compute_dtype, torch.float32)
    ref = DualTrainer(seg, crit, depths(run.config), vars(conf.optim), conf.train.seed + 1,
                      device, real_dtype)
    ref.fault = fault
    del seg, crit
    losses, moments = [], None
    with reference_precision(), Precision.use(precision):
        for s in range(steps):
            rows = [samples[int(i)] for i in idx[s]]
            if half_batch:
                rows = rows[:len(rows) // 2]
            batch = prepare(*(np.stack([r[j] for r in rows]) for j in range(3)),
                            max(conf.model.discriminator_depth, 1), device)
            losses.append(ref.step(batch))
            if s == 0:
                heads = ref.heads.float().cpu()
            if s + 1 == k:
                moments = {n: float(torch.linalg.vector_norm(v))
                           for n, v in ref.first_moments().items()}
    leaves = ref.leaves()
    changes = {n: float(torch.linalg.vector_norm(leaves[n] - init[n])) for n in leaves}
    per_call = [{n: float(np.mean([d[n] for d in losses[c * k:(c + 1) * k]])) for n in losses[0]}
                for c in range(wl["compared_calls"])]
    return per_call, moments, changes, heads


def logit_gap(got, want) -> float:
    """Per image and head, the median over its pixels and classes of the
    logits' gap over max(|reference|, 1); the worst (over the images both
    hold)."""
    n = min(got.shape[1], want.shape[1])
    got, want = got[:, :n].float(), want[:, :n].float()
    gap = (got - want).abs() / want.abs().clamp(min=1.0)
    return float(gap.flatten(2).median(dim=2).values.max())


def readings(prog_losses, prog_moments, prog_changes, prog_heads, ref_losses, ref_moments,
             ref_changes, ref_heads) -> Dict[str, float]:
    """`harness.training.readings`, the median gap of the `_c` branch's
    first moments (`grad_seg_c_median_gap`) and of the "c" critic's changes
    (`change_critic_c_median_gap`), taken as that function takes the
    others (over the median leaf of all; round-off leaves left out of the
    changes), and the first step's logits' gap (`logit_first_gap`)."""
    out = training.readings(prog_losses, prog_moments, prog_changes, ref_losses, ref_moments,
                            ref_changes)
    med = float(np.median(list(ref_moments.values())))
    moving = {n for n, v in ref_moments.items() if v >= training.ROUNDOFF_LEAF * med}
    for name, prog, ref, keep, part in (
            ("grad_seg_c", prog_moments, ref_moments, None, SEG_C),
            ("change_critic_c", prog_changes, ref_changes, moving, CRITIC_C)):
        gaps = training.norm_gaps(prog, ref, keep)
        out[f"{name}_median_gap"] = float(np.median(
            [v for n, v in gaps.items() if n.startswith(part)]))
    out["logit_first_gap"] = logit_gap(prog_heads, ref_heads)
    print("reading " + "; ".join(f"{k} {out[k]!r}" for k in
                                 ("grad_seg_c_median_gap", "change_critic_c_median_gap",
                                  "logit_first_gap")),
          file=sys.stderr)
    return out


def compare(run, conf, prog_losses, prog_moments, prog_changes, prog_heads):
    """(the checks of the workload's limits, every number compared)."""
    got = readings(prog_losses, prog_moments, prog_changes, prog_heads,
                   *reference_run(run, conf))
    return [Check(name, got[name], float(limit))
            for name, limit in run.workload["limits"].items()], got
