"""Segmentation metrics: exact confusion counts and a binned-ROC AUC, and
the host metrics (hard Dice, exact AUC, centerline Dice).

The port of `octave_tpu/utils/metrics.py` (:18-232). Per-batch counts are
int64 tensors on the device (no host round trip per batch); the eval harness
adds batches on the host in numpy int64 (`astype64`), so dataset-scale
counts never round. The ratio methods work on both forms. `auc_exact` and
`cl_dice` are host numpy / scipy functions, copies of the JAX package's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


def _sample_weight(weight: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """(b,) weight in {0, 1} -> int64 broadcastable against `like` (b, ...)."""
    if weight is None:
        return torch.ones((), dtype=torch.int64, device=like.device)
    return weight.round().long().reshape((like.shape[0],) + (1,) * (like.ndim - 1))


class ConfusionAccumulator(NamedTuple):
    """Streaming confusion counts of a binary (vessel) class."""

    tp: object
    fp: object
    fn: object
    tn: object

    @classmethod
    def empty(cls, *, device: torch.device | str) -> "ConfusionAccumulator":
        """Zero counts on `device` (a required keyword: no default device)."""
        z = torch.zeros((), dtype=torch.int64, device=device)
        return cls(z, z, z, z)

    @classmethod
    def empty_host(cls) -> "ConfusionAccumulator":
        """numpy int64 accumulator for dataset aggregation on the host."""
        z = np.int64(0)
        return cls(z, z, z, z)

    def astype64(self) -> "ConfusionAccumulator":
        """Device counts -> host int64."""
        counts = torch.stack([torch.as_tensor(x) for x in self]).cpu().numpy()
        return ConfusionAccumulator(*counts.astype(np.int64))

    def update(self, pred: torch.Tensor, target: torch.Tensor,
               weight: Optional[torch.Tensor] = None) -> "ConfusionAccumulator":
        """pred/target (b, ...) binary maps; a sample of weight 0 is dropped
        (fractional weights are not supported: counts are exact integers)."""
        w = _sample_weight(weight, pred)
        p, t = pred.long(), target.long()
        return ConfusionAccumulator(
            self.tp + (w * p * t).sum(),
            self.fp + (w * p * (1 - t)).sum(),
            self.fn + (w * (1 - p) * t).sum(),
            self.tn + (w * (1 - p) * (1 - t)).sum(),
        )

    def dice(self, eps: float = 1e-12):
        return 2 * self.tp / (2 * self.tp + self.fp + self.fn + eps)

    def iou(self, eps: float = 1e-12):
        return self.tp / (self.tp + self.fp + self.fn + eps)

    def accuracy(self, eps: float = 1e-12):
        return (self.tp + self.tn) / (self.tp + self.fp + self.fn + self.tn + eps)

    def sensitivity(self, eps: float = 1e-12):
        return self.tp / (self.tp + self.fn + eps)

    def specificity(self, eps: float = 1e-12):
        return self.tn / (self.tn + self.fp + eps)


def dice_score(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Hard Dice over the whole batch of binary maps (:93-98), in float32."""
    p, t = pred.float(), target.float()
    return 2 * (p * t).sum() / (p.sum() + t.sum() + eps)


class AucAccumulator(NamedTuple):
    """Binned-ROC AUC: positive and negative scores histogrammed into fixed
    bins on the device; the AUC is the trapezoid over the binned ROC."""

    pos_hist: object  # (bins,)
    neg_hist: object

    @classmethod
    def empty(cls, bins: int = 4096, *, device: torch.device | str) -> "AucAccumulator":
        """Empty histograms on `device` (a required keyword: no default device)."""
        z = torch.zeros((bins,), dtype=torch.int64, device=device)
        return cls(z, z)

    @classmethod
    def empty_host(cls, bins: int = 4096) -> "AucAccumulator":
        return cls(np.zeros((bins,), np.int64), np.zeros((bins,), np.int64))

    def astype64(self) -> "AucAccumulator":
        return AucAccumulator(*(torch.as_tensor(x).cpu().numpy().astype(np.int64) for x in self))

    def update(self, scores: torch.Tensor, target: torch.Tensor,
               weight: Optional[torch.Tensor] = None) -> "AucAccumulator":
        bins = self.pos_hist.shape[0]
        # binned in the scores' own dtype, as the JAX accumulator bins them
        # (x bins, a power of two, is exact in every float dtype)
        s = scores.reshape(-1).clamp(0.0, 1.0)
        t = target.reshape(-1).long()
        idx = (s * bins).long().clamp(0, bins - 1)
        # one histogram over [negatives | positives | dropped samples], of a
        # fixed length (a bincount's length would depend on the data, a host
        # sync that a CUDA-graph capture refuses); integer adds are exact in
        # any order
        key = idx + bins * t
        if weight is not None:
            keep = torch.broadcast_to(_sample_weight(weight, scores), scores.shape).reshape(-1)
            key = torch.where(keep > 0, key, 2 * bins)
        counts = torch.zeros(2 * bins + 1, dtype=torch.int64, device=key.device)
        counts.index_add_(0, key, torch.ones_like(key))
        return AucAccumulator(self.pos_hist + counts[bins:2 * bins],
                              self.neg_hist + counts[:bins])

    def auc(self, eps: float = 1e-12):
        """Rank statistic on the binned scores with tie correction (each bin
        adds a trapezoid). numpy accumulators compute in float64."""
        if isinstance(self.pos_hist, np.ndarray):
            xp, cat, flip = np, np.concatenate, (lambda a: a[::-1])
            cpos = np.cumsum(flip(self.pos_hist)).astype(np.float64)
            cneg = np.cumsum(flip(self.neg_hist)).astype(np.float64)
        else:
            xp, cat = torch, torch.cat
            cpos = torch.cumsum(self.pos_hist.flip(0), 0).double()
            cneg = torch.cumsum(self.neg_hist.flip(0), 0).double()
        zero = cpos[:1] * 0
        tpr = cat([zero, cpos / (cpos[-1] + eps)])
        fpr = cat([zero, cneg / (cneg[-1] + eps)])
        return xp.sum((fpr[1:] - fpr[:-1]) * 0.5 * (tpr[1:] + tpr[:-1]))


def auc_exact(scores, target) -> float:
    """Exact AUC on the host (:162-187): the Mann-Whitney U statistic with
    tied scores given their average rank; nan without both classes."""
    s = np.asarray(scores).reshape(-1)
    t = np.asarray(target).reshape(-1).astype(bool)
    n_pos = int(t.sum())
    n_neg = t.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    sorted_s = s[order]
    # average rank of each run of tied scores (1-based)
    starts = np.flatnonzero(np.r_[True, sorted_s[1:] != sorted_s[:-1]])
    ends = np.r_[starts[1:], s.size]
    ranks = np.empty(s.size, np.float64)
    ranks[order] = np.repeat(0.5 * (starts + 1 + ends), ends - starts)
    u = ranks[t].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def cl_dice(pred, target) -> float:
    """Centerline Dice on the host (:190-214), a topology-aware vessel
    metric: the harmonic mean of the share of pred's skeleton inside target
    and of target's skeleton inside pred. The skeleton is the JAX package's
    morphological one (erode until empty, keeping what an opening removes)."""
    from scipy.ndimage import binary_erosion, binary_opening

    def skel(m):
        m = m.astype(bool)
        out = np.zeros_like(m)
        er = m
        while er.any():
            out |= er & ~binary_opening(er)
            er = binary_erosion(er)
        return out

    p = np.asarray(pred).astype(bool)
    t = np.asarray(target).astype(bool)
    sp, st = skel(p), skel(t)
    eps = 1e-12
    tprec = (sp & t).sum() / (sp.sum() + eps)
    tsens = (st & p).sum() / (st.sum() + eps)
    return float(2 * tprec * tsens / (tprec + tsens + eps))


def eval_step_metrics(probs: torch.Tensor, target: torch.Tensor,
                      threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """One batch's metrics: probs (b,h,w) vessel probability, target (b,h,w)
    binary ground truth."""
    acc = ConfusionAccumulator.empty(device=probs.device).update((probs >= threshold).long(), target)
    auc = AucAccumulator.empty(device=probs.device).update(probs, target)
    return {
        "dice": acc.dice(),
        "iou": acc.iou(),
        "accuracy": acc.accuracy(),
        "sensitivity": acc.sensitivity(),
        "specificity": acc.specificity(),
        "auc": auc.auc(),
    }
