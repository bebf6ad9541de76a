"""The OCTAve ResNeSt U-Net segmentor with Adversarial Attention Gates (eval).

The port of `octave_tpu/models/segmentor.py` (ResnestUNet, :168-329, and
AdversarialAttentionGate, :64-97). Module names follow the reference torch
state dict (`encoder_0_1_2`, `encoder_1..4`, `upsampling_i.up`, `decoder_i`,
`aag_i.conv1`, `fc`). The public boundary is NHWC, as in the JAX package:
`forward` takes (B,H,W,3) and returns (attentions finest-first, agg_map, x_4)
as NHWC tensors.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.models.resnest import (
    ResNestDecoder,
    Upsampling,
    nchw,
    nhwc,
    resnest50,
)
from octave_tpu_torch.ops.common import max_pool2d
from octave_tpu_torch.ops.kernels.aag import fused_aag

# decoder depth -> (Upsampling in, out, ResNestDecoder in, out)
_DECODER_WIDTHS = {
    0: (64, 64, 64, 32),
    1: (256, 64, 128, 64),
    2: (512, 256, 512, 256),
    3: (1024, 512, 1024, 512),
    4: (2048, 1024, 2048, 1024),
}


class AdversarialAttentionGate(nn.Module):
    """1x1 conv to K class logits, softmax over K, mask = sum of the non-
    background probabilities, x * mask. Runs as one fused pass: the Triton
    kernel on CUDA, its plain version on the CPU (ops/kernels/aag.py)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B,C,H,W) -> (masked x (B,C,H,W), y_hat (B,H,W,K))."""
        k = self.conv1.out_channels
        out, yhat = fused_aag(nhwc(x), self.conv1.weight.view(k, -1).t(), self.conv1.bias)
        return nchw(out), yhat


def pad_odd(x: torch.Tensor) -> Tuple[torch.Tensor, bool, bool]:
    """Zero-pad an odd H/W to even at the bottom/right (x_3 at 304²: 19 -> 20)."""
    down, right = x.shape[2] % 2 == 1, x.shape[3] % 2 == 1
    if down or right:
        x = F.pad(x, (0, int(right), 0, int(down)))
    return x, down, right


def crop_pad(d: torch.Tensor, down: bool, right: bool) -> torch.Tensor:
    """Undo `pad_odd` on an NCHW map."""
    return d[:, :, : d.shape[2] - int(down), : d.shape[3] - int(right)]


def apply_prediction_method(agg_map: torch.Tensor, method: str, dim: int = -1) -> torch.Tensor:
    """predict()'s post-processing: softmax | sigmoid | one-hot | original."""
    if method == "softmax":
        return torch.softmax(agg_map, dim=dim)
    if method == "sigmoid":
        return torch.sigmoid(agg_map)
    if method == "one-hot":
        hot = F.one_hot(agg_map.argmax(dim=dim), agg_map.shape[dim]).to(agg_map.dtype)
        return hot.movedim(-1, dim)
    if method == "original":
        return agg_map
    raise ValueError(f"Unknown prediction method: {method}")


class ResnestUNet(nn.Module):
    """ResNeSt-50 encoder + attention-gated U-Net decoder, eval forward.

    Encoder taps 64/256/512/1024/2048 channels, decoder 1024/512/256/64/32,
    final 1x1 conv 32 -> num_classes. Depths <= gating_level are gated.
    With use_fused_decoder (eval only) each gated depth's decoder tail and
    gate run as one fused epilogue kernel; otherwise the gate is the fused
    AAG kernel after the plain decoder block."""

    def __init__(self, num_classes: int = 2, gating_level: int = 4,
                 use_fused_decoder: bool = False):
        super().__init__()
        self.gating_level = gating_level
        self.use_fused_decoder = use_fused_decoder
        bb = resnest50()
        self.encoder_0_1_2 = nn.Sequential(bb.conv1, bb.bn1, bb.relu)
        for i in range(1, 5):
            setattr(self, f"encoder_{i}", getattr(bb, f"layer{i}"))
        for depth, (ui, uo, di, do) in _DECODER_WIDTHS.items():
            setattr(self, f"upsampling_{depth}", Upsampling(ui, uo))
            setattr(self, f"decoder_{depth}", ResNestDecoder(di, do))
            setattr(self, f"aag_{depth}", AdversarialAttentionGate(do, num_classes))
        self.fc = nn.Conv2d(32, num_classes, 1)

    def forward(self, x: torch.Tensor):
        """x (B,H,W,3) -> (attentions finest-first (B,h,w,K) each,
        agg_map (B,H,W,K), x_4 (B,h,w,2048)), all NHWC."""
        x = nchw(x)
        x_0_0 = self.encoder_0_1_2(x)
        x_1 = self.encoder_1(max_pool2d(x_0_0, 3, 2, 1))
        x_2 = self.encoder_2(x_1)
        x_3 = self.encoder_3(x_2)
        x_3, down, right = pad_odd(x_3)
        x_4 = self.encoder_4(x_3)

        attentions: List[torch.Tensor] = []
        fuse = self.use_fused_decoder and not self.training

        def stage(depth: int, skip, up):
            inp = up if skip is None else torch.cat([skip, up], dim=1)
            decoder = getattr(self, f"decoder_{depth}")
            aag = getattr(self, f"aag_{depth}")
            if self.gating_level < depth:
                return decoder(inp)
            if fuse:
                d, y = decoder(inp, gate=aag.conv1)
            else:
                d, y = aag(decoder(inp))
            attentions.append(y)
            return d

        d_4 = self.upsampling_4(x_4)
        d = stage(4, crop_pad(x_3, down, right), crop_pad(d_4, down, right))
        d = stage(3, x_2, self.upsampling_3(d))
        d = stage(2, x_1, self.upsampling_2(d))
        d = stage(1, x_0_0, self.upsampling_1(d))
        d = stage(0, None, self.upsampling_0(d))  # depth 0 has no skip
        agg_map = self.fc(d)
        attentions.reverse()
        return tuple(attentions), nhwc(agg_map), nhwc(x_4)

    def predict(self, x: torch.Tensor, method: str = "softmax"):
        """(attentions, apply_prediction_method(agg_map, method)), NHWC."""
        attentions, agg_map, _ = self(x)
        return attentions, apply_prediction_method(agg_map, method)
