"""Pooling, the 2x2 transposed conv of the ResNeSt U-Net, and nearest resize.

PyTorch's own operators have the reference's semantics natively, so these are
thin named wrappers that fix the arguments each call site of the reference
uses (the JAX package rebuilt them from reduce_window, octave_tpu/ops/common.py).
The pools and the conv take NCHW; `nearest_resize` takes the NHWC maps of the
losses and the data path. The transposed conv has the JAX package's two
lowerings (`set_conv_transpose_impl`, :272-310), selected module-wide.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from octave_tpu_torch.ops import remat

CONV_TRANSPOSE_IMPLS = ("einsum", "native")
_CONV_TRANSPOSE_IMPL = "native"


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view (free for a channels_last tensor)."""
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def nchw(t: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC tensor -> channels_last NCHW view."""
    return t.permute(0, 3, 1, 2)


def max_pool2d(x: torch.Tensor, kernel_size: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """The stem's MaxPool2d(3, 2, 1)."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel_size: int, stride: int, padding: int = 0,
               count_include_pad: bool = True, ceil_mode: bool = False) -> torch.Tensor:
    """AvgPool2d with torch semantics: the avd layer is (3, s, 1) counting the
    padding; the avg_down shortcut is (s, s, 0) with ceil_mode and without.

    torch's CUDA backward of a pad-counting avg_pool2d over a channels_last
    input returns a wrong input gradient (relative error ~1 for (3, 2, 1);
    torch 2.11 on an H100; the forward and NCHW inputs are right). So when a
    gradient will flow through such a pool on CUDA, it pools an NCHW copy."""
    if (count_include_pad and x.is_cuda and x.requires_grad and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        out = F.avg_pool2d(x.contiguous(), kernel_size, stride, padding, ceil_mode=ceil_mode)
        return out.contiguous(memory_format=torch.channels_last)
    return F.avg_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def set_conv_transpose_impl(impl: str) -> None:
    """Select the lowering of `conv_transpose_2x2` for the whole process, as
    the JAX package's switch does: 'native' (the default, cuDNN's
    ConvTranspose2d) or 'einsum' (one matmul and an interleave). The int8
    ConvTranspose follows it too (`ops/quant.py`)."""
    global _CONV_TRANSPOSE_IMPL
    if impl not in CONV_TRANSPOSE_IMPLS:
        raise ValueError(f"unknown conv transpose impl {impl!r}; expected one of "
                         f"{CONV_TRANSPOSE_IMPLS}")
    _CONV_TRANSPOSE_IMPL = impl


def conv_transpose_impl() -> str:
    """The lowering `set_conv_transpose_impl` selected."""
    return _CONV_TRANSPOSE_IMPL


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """ConvTranspose2d(kernel_size=2, stride=2) of an NCHW x; `weight` is
    (C_in, C_out, 2, 2).

    Under 'einsum' each input pixel expands to its own 2x2 output block, so
    the op is one (B*H*W, C_in) x (C_in, 4*C_out) matmul, with the weight's
    columns in (i, j, C_out) order and the bias added by the matmul, then
    the blocks interleaved into the NHWC rows of the output: the JAX
    package's einsum 'bhwc,coij->bhiwjo' written as channels_last NCHW. The
    interleave's copy is the `conv_out` tensor that the save-the-convs remat
    policy keeps (`ops/remat.py`), as the JAX package tags both lowerings."""
    if _CONV_TRANSPOSE_IMPL == "native":
        return F.conv_transpose2d(x, weight, bias, stride=2)
    b, cin, h, w = x.shape
    cout = weight.shape[1]
    cols = weight.permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, cin)
    if bias is None:
        y = rows @ cols
    else:
        y = torch.addmm(bias.repeat(4), rows, cols)
    y = y.view(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    with remat.conv_out():
        y = y.reshape(b, 2 * h, 2 * w, cout)
    return y.permute(0, 3, 1, 2)


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC nearest-neighbour resize with torch's index rule
    src = floor(dst * in / out), in integer arithmetic as the JAX package
    computes it (octave_tpu/ops/common.py:246-264); any dtype."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(1, rows).index_select(2, cols)
