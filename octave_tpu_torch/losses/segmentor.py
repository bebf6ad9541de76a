"""Weakly-supervised segmentation losses over NHWC tensors.

The port of `octave_tpu/losses/segmentor.py`: weighted partial cross-entropy
(:23-81), soft Dice (:84-90), image MSE (:93-95), the InterlayerDivergence
(ILD) in its pooled KLD form (:106-141) and its resize form with KLD and JSD
(:144-202), and weighted CE (:205-216). The reference's quirks are kept:
  * WPCE class weights count the background channel too;
  * ILD skips a zero-weight layer but still counts its weight in sum(weights),
    and truncates an over-long weight list to len(attentions);
  * KLD 'mean' is taken against the weighted-average log posterior, not the
    log of the mean posterior.
Under data parallelism (`global_counts`) the WPCE class counts are summed
over every rank (:48-53), so each rank weighs its shard by the counts of the
global batch and the mean gradient equals the full batch's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from octave_tpu_torch.ops.common import nearest_resize
from octave_tpu_torch.parallel import ddp

_EPS = 1e-12


def weighted_partial_ce(
    y_hat: torch.Tensor,
    ys: torch.Tensor,
    num_classes: int,
    manual: bool = True,
    ignore_bg: bool = False,
    reduction: str = "mean",
    full: bool = False,
    global_counts: bool = False,
) -> torch.Tensor:
    """WPCE over scribble pixels. y_hat (b,h,w,c): probabilities (manual) or
    logits (the torch-CE fallback); ys (b,h,w,c) scribble one-hot.

    Class weights w_c = n_tot / (n_c + 1e-12), n_c counting scribble pixels
    per class including the background channel, over every rank of the
    process group with `global_counts`. Unless full, y_hat is masked to the
    annotated pixels."""
    if y_hat.shape[-1] != ys.shape[-1]:
        raise ValueError("Number of class mismatch.")
    if ignore_bg:
        ys = torch.cat([torch.zeros_like(ys[..., :1]), ys[..., 1:]], dim=-1)
    if not full:
        y_hat = y_hat * ys
    ni = ys.sum(dim=(0, 1, 2))
    if global_counts:
        ni = ddp.all_reduce_sum(ni)
    weights = ni.sum() / (ni + _EPS)

    if num_classes == 1:  # BCE-with-logits fallback
        z, t = y_hat.reshape(-1), ys.reshape(-1)
        return torch.mean(torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs())))
    if manual:
        per_pixel = -torch.sum(weights * ys * torch.log(y_hat + _EPS), dim=-1)
        return per_pixel.mean() if reduction == "mean" else per_pixel.sum()
    # torch CrossEntropyLoss fallback: flattened foreground mask as targets
    logp = torch.log_softmax(y_hat.reshape(-1, y_hat.shape[-1]), dim=-1)
    targets = ys[..., 1:].reshape(-1).long()
    return -logp.gather(1, targets[:, None])[:, 0].mean()


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Soft Dice per batch item (cardinality x + y, not squared), mean over
    the batch."""
    dims = tuple(range(1, inputs.ndim))
    intersect = (inputs * targets).sum(dim=dims)
    cardinal = (inputs + targets).sum(dim=dims)
    return torch.mean(1.0 - 2.0 * intersect / (cardinal + eps))


def image_mse_loss(y_h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Flattened MSE."""
    return torch.mean(torch.square(y_h.reshape(-1) - y.reshape(-1).to(y_h.dtype)))


def _sum_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Sum over non-overlapping factor x factor blocks of an NHWC map."""
    b, h, w, c = x.shape
    return x.reshape(b, h // factor, factor, w // factor, factor, c).sum(dim=(2, 4))


def _ild_weights(rest: list, weights: Optional[Sequence[float]], n_att: int) -> List[float]:
    if weights is None:
        return [1 for _ in rest]
    weights = list(weights)
    if len(weights) != len(rest):
        weights = weights[:n_att]  # the reference's truncation quirk
    return weights


def interlayer_divergence_pooled(
    attentions: Sequence[torch.Tensor],
    weights: Optional[Sequence[float]] = None,
    stop_gradient: bool = False,
) -> torch.Tensor:
    """KLD-mode ILD without materialising the upscaled posteriors: a nearest
    upscale by an integer factor is a repeat, so
        sum_p basis(p) log(resize(att) w)(p) = sum_s sumpool(basis)(s) log(att w)(s).
    Equal to `interlayer_divergence` when every scale divides the basis."""
    basis = attentions[0].detach() if stop_gradient else attentions[0]
    h, w = basis.shape[1], basis.shape[2]
    rest = list(attentions[1:])
    weights = _ild_weights(rest, weights, len(attentions))
    n_pix = basis.shape[0] * h * w
    ent = torch.sum(basis * torch.log(basis + _EPS))
    cross = 0.0
    for att, weight in zip(rest, weights):
        if weight == 0:
            continue
        ah, aw = att.shape[1], att.shape[2]
        if h % ah or w % aw:
            raise ValueError("pooled ILD needs integer scales")
        fb = _sum_pool(basis, h // ah) if (ah, aw) != (h, w) else basis
        cross = cross + torch.sum(fb * torch.log(att * weight + _EPS))
    return (ent - cross / sum(weights)) / n_pix


def interlayer_divergence(
    attentions: Sequence[torch.Tensor],
    weights: Optional[Sequence[float]] = None,
    mode: str = "mean",
    eps: float = _EPS,
    stop_gradient: bool = False,
    divergence: str = "KLD",
) -> torch.Tensor:
    """Self-supervised deep supervision over a finest-first pyramid of
    (b,h,w,c) softmax maps, each deeper map nearest-upscaled to the basis.

    KLD: mean over pixels of sum_c basis (log basis - m_log_prob), with
    m_log_prob = sum_a log(resize(att_a) w_a + eps) / sum(w).
    JSD: against the mean of the weighted posteriors."""
    basis = attentions[0].detach() if stop_gradient else attentions[0]
    h, w = basis.shape[1], basis.shape[2]
    rest = list(attentions[1:])
    weights = _ild_weights(rest, weights, len(attentions))
    posterior = [nearest_resize(att, (h, w)) * weight
                 for att, weight in zip(rest, weights) if weight != 0]
    log_basis = torch.log(basis + _EPS)

    if divergence == "KLD":
        if mode != "mean":
            raise NotImplementedError("Only 'mean' mode is implemented (as in the reference).")
        m_log_prob = torch.log(torch.stack(posterior) + _EPS).sum(dim=0) / sum(weights)
        return torch.sum(basis * (log_basis - m_log_prob), dim=-1).mean()
    if divergence == "JSD":
        mean_q = torch.stack(posterior).mean(dim=0)
        log_mixture = torch.log(0.5 * (basis + mean_q) + eps)
        log_mean_q = torch.log(mean_q + _EPS)
        kld_p = torch.sum(0.5 * basis * (log_basis - log_mixture), dim=-1).mean()
        kld_q = torch.sum(0.5 * mean_q * (log_mean_q - log_mixture), dim=-1).mean()
        return kld_p + kld_q
    raise NotImplementedError(f"Invalid divergence type / Not implemented: {divergence}")


def ce_loss(y_pred: torch.Tensor, y_true: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted CE against argmax(y_true); torch's mean reduction divides by
    the summed weights of the realised targets."""
    logp = torch.log_softmax(y_pred.reshape(-1, y_pred.shape[-1]), dim=-1)
    targets = y_true.reshape(-1, y_true.shape[-1]).argmax(dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    wt = weight[targets]
    return torch.sum(wt * nll) / torch.sum(wt)


# The reference's loss classes (losses.py), as octave_tpu/losses/segmentor.py
# :224-278 wraps them: constructor arguments, then a call on tensors.


class WeightedPartialCE:
    """The reference's WeightedPartialCE (losses.py:11-24)."""

    def __init__(self, num_classes: int, eps: float = _EPS, manual: bool = False):
        self.num_classes = num_classes
        self.eps = eps
        self.manual = manual

    def __call__(self, y_hat, ys, ignore_bg: bool = False, reduction="mean", **kwargs):
        return weighted_partial_ce(y_hat, ys, self.num_classes, manual=self.manual,
                                   ignore_bg=ignore_bg, reduction=reduction,
                                   full=kwargs.get("full", False))


class DiceLoss:
    def __init__(self, eps: float = _EPS):
        self.eps = eps

    def __call__(self, inputs, targets):
        return dice_loss(inputs, targets, self.eps)


class ImageMseLoss:
    def __call__(self, y_h, y):
        return image_mse_loss(y_h, y)


class InterlayerDivergence:
    """The reference's InterlayerDivergence (losses.py:90-109); its 'sum'
    mode raises NotImplementedError, as the reference does."""

    def __init__(self, mode="mean", eps: float = _EPS, upscaling_mode="nn",
                 stop_gradient: bool = False, divergence="KLD"):
        if mode not in ("mean", "sum"):
            raise ValueError(f"mode {mode} is not exists/implemented.")
        if mode == "sum":
            raise NotImplementedError("Not implemented yet.")
        self.mode = mode
        self.eps = eps
        self.stop_gradient = stop_gradient
        self.divergence = divergence

    def __call__(self, attentions, weights=None):
        return interlayer_divergence(attentions, weights=weights, mode=self.mode, eps=self.eps,
                                     stop_gradient=self.stop_gradient,
                                     divergence=self.divergence)


class CELoss:
    def __init__(self, weight):
        self.weight = torch.as_tensor(weight)

    def __call__(self, y_pred, y_true):
        return ce_loss(y_pred, y_true, self.weight.to(y_pred.device))
