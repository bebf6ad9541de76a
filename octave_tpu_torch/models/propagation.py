"""ROSE coarse-to-fine propagation / adaptive-aggregation blocks.

The port of `octave_tpu/models/propagation.py` (:34-226). The reference
builds these from raw convolutions plus a fixed one-hot "mapping kernel" (k²
filters of shape 1 x k x k, each selecting one neighbourhood offset);
`extract_neighborhood` computes the same thing as a zero pad and k² shifted
slices. All maps are NHWC, as in the JAX package.

The reference's trunk of basePC / baseC / baseMulti is `base` here, with the
JAX tree's names: `base.conv1`, `bn1`, `conv4`, `bn4`, `conv7`, `bn7`. Its
conv kernels start from N(avg, std) and conv7's bias is zero except a one
at the centre channel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.models.resnest import nchw, nhwc
from octave_tpu_torch.ops.norm import BatchNorm2d


def clip_by_tensor(t: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """Elementwise clip, in float32."""
    return t.float().clamp(t_min, t_max)


def extract_neighborhood(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """x (b,h,w,1) -> (b,h,w,k²): channel kh*k + kw holds the input shifted
    by the kernel offset (kh, kw), zero beyond the borders; the channel order
    of F.conv2d with the reference's one-hot mapping kernels, padding k//2."""
    b, h, w, c = x.shape
    if c != 1:
        raise ValueError(f"extract_neighborhood takes one channel, got {c}")
    k, p = kernel_size, kernel_size // 2
    padded = F.pad(x[..., 0], (p, p, p, p))
    return torch.stack([padded[:, kh:kh + h, kw:kw + w] for kh in range(k) for kw in range(k)],
                       dim=-1)


class _PropagationBase(nn.Module):
    """Three full-pad convs, each followed by BN and ReLU, then a softmax
    over the pn² coefficient channels: (b,h,w,in) -> (b,h,w,pn²)."""

    def __init__(self, in_channels: int, channels: int = 256, pn_size: int = 5,
                 kernel_size: int = 3, avg: float = 0.0, std: float = 0.1):
        super().__init__()
        k, p, n_out = kernel_size, kernel_size // 2, pn_size * pn_size
        if n_out % 2 != 1:
            raise ValueError(f"pn_size {pn_size}: the centre-one bias needs an odd pn_size")
        self.conv1 = nn.Conv2d(in_channels, channels, k, 1, p, bias=False)
        self.bn1 = BatchNorm2d(channels)
        self.conv4 = nn.Conv2d(channels, 2 * channels, k, 1, p, bias=False)
        self.bn4 = BatchNorm2d(2 * channels)
        self.conv7 = nn.Conv2d(2 * channels, n_out, k, 1, p, bias=True)
        self.bn7 = BatchNorm2d(n_out)
        with torch.no_grad():
            for conv in (self.conv1, self.conv4, self.conv7):
                nn.init.normal_(conv.weight, avg, std)
            self.conv7.bias.zero_()
            self.conv7.bias[n_out // 2] = 1.0

    def forward(self, input_all: torch.Tensor) -> torch.Tensor:
        fm = F.relu(self.bn1(self.conv1(nchw(input_all))))
        fm = F.relu(self.bn4(self.conv4(fm)))
        fm = F.relu(self.bn7(self.conv7(fm)))
        return nhwc(torch.softmax(fm, dim=1))


class BasePC(nn.Module):
    """Propagation coefficients from the source, thick and thin maps."""

    def __init__(self, channels: int = 256, pn_size: int = 5, kernel_size: int = 3,
                 avg: float = 0.0, std: float = 0.1):
        super().__init__()
        self.base = _PropagationBase(3, channels, pn_size, kernel_size, avg, std)

    def forward(self, input_src, input_thick, input_thin) -> torch.Tensor:
        input_all = torch.cat((input_src, input_thick, input_thin), dim=-1)
        if input_all.shape[-1] != 3:
            raise ValueError("Expect concatenated confidence map to have channel depth of 3. "
                             f"Got {tuple(input_all.shape)} instead.")
        return self.base(input_all)


class AdaptiveAggregationPC(nn.Module):
    """max(thick, thin), aggregated over its pn x pn neighbourhood with the
    coefficients."""

    def __init__(self, pn_size: int = 5):
        super().__init__()
        self.pn_size = pn_size

    def forward(self, input_thick, input_thin, agg_coeff) -> torch.Tensor:
        return _aggregate(torch.maximum(input_thick, input_thin), agg_coeff, self.pn_size)


class BaseC(nn.Module):
    """Propagation coefficients from the source and thin maps."""

    def __init__(self, channels: int = 256, pn_size: int = 5, kernel_size: int = 3,
                 avg: float = 0.0, std: float = 0.1):
        super().__init__()
        self.base = _PropagationBase(2, channels, pn_size, kernel_size, avg, std)

    def forward(self, input_src, input_thin) -> torch.Tensor:
        input_all = torch.cat((input_src, input_thin), dim=-1)
        if input_all.shape[-1] != 2:
            # the reference's message, "depth of 3" included
            raise ValueError("Expect concatenated confidence map to have channel depth of 3. "
                             f"Got {tuple(input_all.shape)} instead.")
        return self.base(input_all)


class AdaptiveAggregationC(nn.Module):
    """The thin map aggregated over its neighbourhood."""

    def __init__(self, pn_size: int = 5):
        super().__init__()
        self.pn_size = pn_size

    def forward(self, input_thin, agg_coeff) -> torch.Tensor:
        return _aggregate(input_thin, agg_coeff, self.pn_size)


class BaseMulti(nn.Module):
    """Propagation coefficients from the first `in_channels` maps of a list."""

    def __init__(self, in_channels: int = 3, channels: int = 256, pn_size: int = 5,
                 kernel_size: int = 3, avg: float = 0.0, std: float = 0.1):
        super().__init__()
        self.in_channels = in_channels
        self.base = _PropagationBase(in_channels, channels, pn_size, kernel_size, avg, std)

    def forward(self, basis: Sequence[torch.Tensor]) -> torch.Tensor:
        input_all = torch.cat(list(basis)[: self.in_channels], dim=-1)
        if input_all.shape[-1] != self.in_channels:
            raise ValueError(f"Expect the input to had {self.in_channels} channels, "
                             f"got {input_all.shape[-1]} instead.")
        return self.base(input_all)


class AdaptiveAggregationMulti(nn.Module):
    """The max-probability map aggregated over its neighbourhood."""

    def __init__(self, pn_size: int = 5):
        super().__init__()
        self.pn_size = pn_size

    def forward(self, max_prob_input, agg_coeff) -> torch.Tensor:
        return _aggregate(max_prob_input, agg_coeff, self.pn_size)


def _aggregate(saliency: torch.Tensor, agg_coeff: torch.Tensor, pn_size: int) -> torch.Tensor:
    """sum over the neighbourhood of saliency * coefficient: (b,h,w,1)."""
    neighbours = extract_neighborhood(saliency, pn_size)
    if agg_coeff.shape != neighbours.shape:
        raise ValueError(f"coefficients {tuple(agg_coeff.shape)} do not match the "
                         f"{pn_size}x{pn_size} neighbourhood {tuple(neighbours.shape)}")
    return (neighbours * agg_coeff).sum(dim=-1, keepdim=True)


def global_average_pooling_2d(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims of an NHWC map: (b,h,w,c) -> (b,c)."""
    return x.mean(dim=(1, 2))
