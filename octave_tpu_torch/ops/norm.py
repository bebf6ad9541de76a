"""Eval batch norm in the reference's two serving forms.

`BatchNorm2d` is torch's BatchNorm2d (the reference's only norm layer) with
one extra eval mode: once `folded_inference(model)` has marked it folded, its
`weight`/`bias` hold the folded affine from `fold_batch_stats` and eval is
y = x * weight + bias, as the JAX package's `folded_inference()` reads it
(octave_tpu/ops/norm.py:58-105). Training uses torch's own forward.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-5


def fold_batch_stats(state_dict: Dict[str, torch.Tensor],
                     eps: float = EPS) -> Dict[str, torch.Tensor]:
    """Fold each BN's running stats into its affine:
        weight' = weight * rsqrt(running_var + eps);  bias' = bias - running_mean * weight'.
    Returns a new state dict; the stats are kept but no longer read once the
    model runs under `folded_inference`."""
    out = dict(state_dict)
    for key, mean in state_dict.items():
        if not key.endswith(".running_mean"):
            continue
        base = key[: -len("running_mean")]
        var = state_dict.get(base + "running_var")
        w, b = base + "weight", base + "bias"
        if var is None or w not in state_dict or b not in state_dict:
            continue
        scale = state_dict[w] * torch.rsqrt(var + eps)
        out[b] = state_dict[b] - mean * scale
        out[w] = scale
    return out


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d whose eval forward can read a folded affine."""

    def __init__(self, num_features: int, eps: float = EPS, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.folded = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        shape = (1, -1, 1, 1)
        if self.folded:
            return torch.addcmul(self.bias.view(shape), x, self.weight.view(shape))
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval BN as a float32 per-channel (scale, bias), raw or folded."""
        if self.folded:
            return self.weight.float(), self.bias.float()
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale


def folded_inference(model: nn.Module, enabled: bool = True) -> nn.Module:
    """Mark every BatchNorm2d of `model` as holding folded weights (or not)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.folded = enabled
    return model
