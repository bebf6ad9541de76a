"""Multi-scale LS-GAN critic with spectral norm and the two noise layers.

The port of `octave_tpu/models/discriminator.py` (:40-207). Parameter and
buffer names follow the reference state dict that the JAX package's
`convert_discriminator` reads (`stack_0.{0|1}`, `squeeze_dict.squeeze_i.0`,
`spectral_dict.spectral_i.0.{weight_orig, bias, weight_u, weight_v}`,
`out.0`), so a reference state dict loads with `load_state_dict`.

Spectral norm keeps its power-iteration vectors u, v as buffers and takes an
explicit `update` switch instead of `torch.nn.utils.spectral_norm`, which
stores a new u, v on every training forward: the train step's generator
phase iterates and throws the result away, as the JAX step does
(octave_tpu/train/steps.py:321-334). Normalisation divides by norm + eps, as
the JAX package does, not by max(norm, eps) as `F.normalize`.

Noise contract (the reference's quirks, kept):
  * InstanceNoise draws one (H, W) map shared over batch and channels and
    adds it in training only; the [0, 1] clip applies in eval too;
  * LabelNoise draws one uniform scalar per forward and is not gated on
    training.
Both draw from the `generator` passed to `DiscriminatorBlock.forward`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC map -> NCHW view (channels_last when t is contiguous)."""
    return t.permute(0, 3, 1, 2)


class SpectralConv(nn.Module):
    """Conv2d whose weight is divided by its largest singular value sigma,
    estimated by one power iteration per training forward on the weight
    flattened to (out, in*kh*kw). Eval reuses the stored u, v. The power
    iteration runs without gradient, so sigma's gradient flows through the
    weight only; u, v and sigma keep the master weight's dtype under autocast
    too."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, eps: float = 1e-12):
        super().__init__()
        self.stride, self.padding, self.eps = stride, padding, eps
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        fan_in = in_channels * kernel_size * kernel_size
        nn.init.kaiming_uniform_(self.weight_orig, a=math.sqrt(5))
        nn.init.uniform_(self.bias, -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
        self.register_buffer("weight_u", _l2_normalize(torch.randn(out_channels)))
        self.register_buffer("weight_v", _l2_normalize(torch.randn(fan_in)))

    def forward(self, x: torch.Tensor, update: bool = True) -> torch.Tensor:
        u, v = self.weight_u, self.weight_v
        with torch.autocast(x.device.type, enabled=False):
            w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
            if self.training:
                with torch.no_grad():
                    v = _l2_normalize(w_mat.t() @ u, self.eps)
                    u = _l2_normalize(w_mat @ v, self.eps)
                if update:
                    self.weight_u.copy_(u)
                    self.weight_v.copy_(v)
            sigma = torch.dot(u, w_mat @ v)
            weight = self.weight_orig / sigma
        return F.conv2d(x, weight, self.bias, self.stride, self.padding)


class InstanceNoise(nn.Module):
    """Gaussian input noise, one (H, W) map per forward, then a [0, 1] clip."""

    def __init__(self, mean: float = 0.0, std: float = 0.2, clipping: bool = True):
        super().__init__()
        self.mean, self.std, self.clipping = mean, std, clipping

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, C, H, W)."""
        if self.training:
            noise = torch.randn(x.shape[2:], generator=generator, device=x.device, dtype=x.dtype)
            x = x + (self.mean + self.std * noise)
        return x.clamp(0.0, 1.0) if self.clipping else x


class LabelNoise(nn.Module):
    """With probability `prob`, flip the sign of the logits ('sign') or map
    them to |1 - x| ('label'); one draw per forward, in eval too."""

    def __init__(self, prob: float = 0.1, mode: str = "sign"):
        super().__init__()
        if mode not in ("sign", "label"):
            raise NotImplementedError(f"label noise mode {mode!r}")
        self.prob, self.mode = prob, mode

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flip = torch.rand((), generator=generator, device=x.device) < self.prob
        return torch.where(flip, -x if self.mode == "sign" else (1.0 - x).abs(), x)


class DiscriminatorBlock(nn.Module):
    """Critic over the finest-first pyramid of (B, H/2^i, W/2^i, K) maps,
    i = 0..depth, returning (B, 1) logits.

    conv_0 (k4 s2 p1) + LeakyReLU(0.2); then per level i a 1x1 squeeze to 13
    channels + sigmoid, concat with level i+1, spectral conv (k4 s2 p1) to
    2^(i+1)*num_filters + tanh; the output conv's kernel spans the whole
    remaining (H/2^(depth+1), W/2^(depth+1)) map."""

    def __init__(self, input_hw: Tuple[int, int], depth: int = 3, num_filters: int = 64,
                 instance_noise: bool = True, label_noise: bool = True,
                 num_classes: int = 2):
        super().__init__()
        nf = num_filters
        self.depth = depth
        self.use_instance_noise = instance_noise
        conv0 = nn.Conv2d(num_classes, nf, 4, 2, 1)
        nn.init.kaiming_normal_(conv0.weight, a=0.0, nonlinearity="leaky_relu")
        self.stack_0 = nn.Sequential(*([InstanceNoise()] if instance_noise else []),
                                     conv0, nn.LeakyReLU(0.2))
        self.squeeze_dict = nn.ModuleDict({
            f"squeeze_{i}": nn.Sequential(nn.Conv2d(nf * 2**i, 13, 1), nn.Sigmoid())
            for i in range(depth)})
        self.spectral_dict = nn.ModuleDict({
            f"spectral_{i}": nn.Sequential(SpectralConv(13 + num_classes, nf * 2 ** (i + 1)),
                                           nn.Tanh())
            for i in range(depth)})
        h, w = (d // 2 ** (depth + 1) for d in input_hw)
        out = nn.Conv2d(nf * 2**depth, 1, (h, w))
        nn.init.xavier_uniform_(out.weight)
        self.out = nn.Sequential(out)
        self.label_noise = LabelNoise() if label_noise else None

    def forward(self, y: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None,
                update: bool = True) -> torch.Tensor:
        """y: depth+1 NHWC maps, finest first. `generator` feeds both noise
        layers; `update=False` runs the power iterations without storing
        them (training mode only; eval never iterates)."""
        s = _nchw(y[0])
        if self.use_instance_noise:
            s = self.stack_0[0](s, generator)
        s = F.leaky_relu(self.stack_0[-2](s), 0.2)
        for i in range(self.depth):
            s = torch.sigmoid(self.squeeze_dict[f"squeeze_{i}"][0](s))
            s = torch.cat((s, _nchw(y[i + 1]).to(s.dtype)), dim=1)
            s = torch.tanh(self.spectral_dict[f"spectral_{i}"][0](s, update))
        out = self.out[0]
        if tuple(s.shape[2:]) == out.kernel_size:
            # the kernel spans the whole map: one dot product per sample, run
            # as a GEMM. cuDNN's implicit GEMM for the depth-1 critic's 76x76
            # kernel (304², B = 8, bf16) took 23.8 ms forward + backward, the
            # GEMM 0.57 ms; at depth 4 (9x9) both ~1.1 ms (H100 80GB HBM3,
            # 700 W; scripts/critic_out_conv.py)
            logits = F.linear(s.permute(0, 2, 3, 1).reshape(s.shape[0], -1),
                              out.weight.permute(0, 2, 3, 1).reshape(1, -1), out.bias)
        else:
            logits = out(s).reshape(s.shape[0], -1)
        if self.label_noise is not None:
            logits = self.label_noise(logits, generator)
        return logits
