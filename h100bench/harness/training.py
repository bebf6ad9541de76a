"""The check of the training cells: the float32 reference follows the
program's first steps from the same seeded weights and batches, and the
program's losses, first moments and changes are held against it."""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from harness.cell import Check

# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves under Adam by round-off alone (a bias before a batch
# norm): its change is left out of the comparison
ROUNDOFF_LEAF = 1e-3


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Per leaf, |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def seeded_weights(run, device):
    """The segmentor's and the critic's seeded float32 weights."""
    import torch

    from reference.model import critic_spec, make_params, segmentor_spec

    cfg = run.config
    hw = tuple(cfg["program_config"]["data"]["image_size"])
    gen = torch.Generator(device=device).manual_seed(run.seed)
    seg = make_params(segmentor_spec(), gen, device)
    crit = make_params(critic_spec(hw, cfg["critic"]["depth"], cfg["critic"]["filters"]), gen,
                       device)
    return seg, crit


def reference_run(run, conf, precision=None, half_batch=False, fault=None):
    """The reference's losses per compared call, its first-moment norms
    after the first call and its change norms after the compared calls;
    `precision` (a `reference.model.Precision` mode), `half_batch` (each
    step on the first half of its rows) and `fault` (planted in the
    reference: `reference.train.Trainer.fault`) are for the controls."""
    import torch

    from harness.serving import reference_precision
    from reference.model import Precision
    from reference.phantoms import batch_indices, synthetic_octa
    from reference.train import Trainer, prepare

    wl, k = run.workload, conf.train.steps_per_call
    steps = wl["compared_calls"] * k
    device = torch.device(run.device)
    seg, crit = seeded_weights(run, device)
    init = {**{"seg/" + n: v.clone() for n, v in seg.items()},
            **{"critic/" + n: v.clone() for n, v in crit.items()}}
    size = tuple(conf.data.image_size)
    depth = max(conf.model.discriminator_depth, 1)
    idx = batch_indices(conf.data.synthetic_n, conf.data.batch_size, conf.train.seed, steps)
    samples = {}
    for i in np.unique(idx):
        samples[int(i)] = synthetic_octa(int(i), conf.train.seed, size)
    real_dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        conf.train.compute_dtype, torch.float32)
    ref = Trainer(seg, crit, conf.model.discriminator_depth, vars(conf.optim),
                  conf.train.seed + 1, device, real_dtype)
    ref.fault = fault
    del seg, crit
    losses, moments = [], None
    with reference_precision(), Precision.use(precision):
        for s in range(steps):
            rows = [samples[int(i)] for i in idx[s]]
            if half_batch:
                rows = rows[:len(rows) // 2]
            batch = prepare(*(np.stack([r[j] for r in rows]) for j in range(3)), depth, device)
            losses.append(ref.step(batch))
            if s + 1 == k:
                moments = {n: float(torch.linalg.vector_norm(v))
                           for n, v in ref.first_moments().items()}
    leaves = ref.leaves()
    changes = {n: float(torch.linalg.vector_norm(leaves[n] - init[n])) for n in leaves}
    per_call = [{n: float(np.mean([d[n] for d in losses[c * k:(c + 1) * k]])) for n in losses[0]}
                for c in range(wl["compared_calls"])]
    return per_call, moments, changes


def readings(prog_losses: List[Dict[str, float]], prog_moments, prog_changes,
             ref_losses, ref_moments, ref_changes) -> Dict[str, float]:
    """The numbers compared: each loss's largest relative gap over the
    compared calls, the largest of them, and each loss's gap at the first
    step (its forward, before any update; a loss the program does not
    report reads NaN); the gaps of each leaf's first moment (the first
    gradient, scaled) and change, the worst leaf's and the median leaf's,
    over all leaves and over the segmentor's and the critic's apart.
    Round-off leaves (ROUNDOFF_LEAF) are left out of the changes."""
    def gap(p, r, n):
        return abs(p.get(n, np.nan) - r[n]) / max(abs(r[n]), 1e-6)

    out = {}
    for n in ref_losses[0]:
        gaps = [gap(p, r, n) for p, r in zip(prog_losses, ref_losses)]
        out[f"{n}_gap"] = float(np.max(gaps))  # NaN if any is
    out["loss_rel_gap"] = float(np.max(list(out.values())))
    for n in ref_losses[0]:
        out[f"{n}_first_gap"] = gap(prog_losses[0], ref_losses[0], n)
    med = float(np.median(list(ref_moments.values())))
    moving = {n for n, v in ref_moments.items() if v >= ROUNDOFF_LEAF * med}
    worst = {}
    for name, prog, ref, keep in (("grad", prog_moments, ref_moments, None),
                                  ("change", prog_changes, ref_changes, moving)):
        gaps = norm_gaps(prog, ref, keep)
        worst[name] = max(gaps, key=gaps.get)
        out[f"{name}_norm_gap"] = gaps[worst[name]]
        out[f"{name}_median_gap"] = float(np.median(list(gaps.values())))
        for part in ("seg", "critic"):
            mine = [v for n, v in gaps.items() if n.startswith(part + "/")]
            out[f"{name}_{part}_median_gap"] = float(np.median(mine))
    print(f"reading worst leaves: grad {worst['grad']}, change {worst['change']}; "
          f"{len(ref_moments) - len(moving)} round-off leaves left out of the changes",
          file=sys.stderr)
    print("reading " + "; ".join(f"{k} {v!r}" for k, v in out.items()), file=sys.stderr)
    return out


def compare(run, conf, prog_losses, prog_moments, prog_changes):
    """(the checks of the workload's limits, every number compared)."""
    ref = reference_run(run, conf)
    got = readings(prog_losses, prog_moments, prog_changes, *ref)
    return [Check(name, got[name], float(limit))
            for name, limit in run.workload["limits"].items()], got
