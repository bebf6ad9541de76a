"""Pooling and the 2x2 transposed conv of the ResNeSt U-Net, over NCHW.

PyTorch's own operators have the reference's semantics natively, so these are
thin named wrappers that fix the arguments each call site of the reference
uses (the JAX package rebuilt them from reduce_window, octave_tpu/ops/common.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel_size: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """The stem's MaxPool2d(3, 2, 1)."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel_size: int, stride: int, padding: int = 0,
               count_include_pad: bool = True, ceil_mode: bool = False) -> torch.Tensor:
    """AvgPool2d with torch semantics: the avd layer is (3, s, 1) counting the
    padding; the avg_down shortcut is (s, s, 0) with ceil_mode and without."""
    return F.avg_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """ConvTranspose2d(kernel_size=2, stride=2); `weight` is (C_in, C_out, 2, 2)."""
    return F.conv_transpose2d(x, weight, bias, stride=2)
