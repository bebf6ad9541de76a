"""Fused eval batch norm, residual join and ReLU: a Triton kernel and its plain version.

Replaces no Pallas kernel: the JAX package leaves its folded batch norms
and the ReLUs and residual adds after them to XLA's fusion. In the port
each was a PyTorch pass of its own. For a channels-last x (B,C,H,W), the
per-channel (C,) `scale`, `bias` of a folded eval batch norm and an
optional residual it computes

    y = relu(round(x * scale + bias) [+ round(r * res_scale + res_bias) | + r])

where each `round` is to x's dtype, at the points where the plain chain
(`addcmul`, `add`, `relu`; `fused_bn_act_plain`) stores its tensors, so
the two agree bit for bit.

Bound on the H100: memory. Per element it reads x (and r) and writes y,
with two to five flops: under one flop per byte in bf16, far under the
card's ridge of ~295. The served ResnestUNet's 82 sites hold 89.8 MB of
bf16 batch-norm outputs per 304² image; the plain chain (read and write in
`addcmul`, again in the ReLU, the residual's own `addcmul` and the add)
moves 431.6 MB of them an image, one pass 200.0 MB. What the design does
about it: a channels-last
activation is a row-major (B*H*W, C) matrix, and each program reads a
[BLOCK_M, BLOCK_C] tile of it once, as rows of contiguous 16-byte vectors
along C, with the affines of its BLOCK_C channels loaded once; the affine,
the residual's own affine, the join and the ReLU stay in registers, and
the tile is written once.
"""
from __future__ import annotations

from typing import Optional

import torch

from octave_tpu_torch.ops.kernels import (
    count_launch,
    next_pow2,
    register_counter,
    triton_build_dir,
)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_CHANNEL = (1, -1, 1, 1)
# register tile of one program: BLOCK_M x BLOCK_C values, 32 a thread at 8
# warps; BLOCK_C at most 128 channels, so narrow and wide sites alike run
# rows of whole 16-byte vectors
_TILE_ELEMS = 8192
_MAX_BLOCK_C = 128
_NUM_WARPS = 8


def fused_bn_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       res_scale: Optional[torch.Tensor] = None,
                       res_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain chain: the folded batch norm's `addcmul`, the residual's
    own (when res_scale is given), the `add` and the ReLU."""
    y = torch.addcmul(bias.view(_CHANNEL), x, scale.view(_CHANNEL))
    if residual is not None:
        if res_scale is not None:
            residual = torch.addcmul(res_bias.view(_CHANNEL), residual, res_scale.view(_CHANNEL))
        y = y + residual
    return torch.relu(y)


def takes(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          residual: Optional[torch.Tensor] = None, res_scale: Optional[torch.Tensor] = None,
          res_bias: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel computes fused_bn_act_plain of these tensors: x
    channels-last contiguous (B,C,H,W) in float32, bf16 or float16; the
    affines (C,) and the residual (x's shape, channels-last contiguous) in
    x's dtype on x's device; res_scale and res_bias together, with a
    residual; and no gradient to record (the kernel has no backward)."""
    if x.ndim != 4 or x.dtype not in _DTYPES or not x.is_contiguous(
            memory_format=torch.channels_last):
        return False
    if (res_scale is None) != (res_bias is None) or (residual is None and res_scale is not None):
        return False
    c = x.shape[1]
    affines = [t for t in (scale, bias, res_scale, res_bias) if t is not None]
    if any(t.shape != (c,) or t.dtype != x.dtype or t.device != x.device
           or not t.is_contiguous() for t in affines):
        return False
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device or not residual.is_contiguous(
                                     memory_format=torch.channels_last)):
        return False
    tensors = affines + [x] + ([] if residual is None else [residual])
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def _launch(x, scale, bias, residual, res_scale, res_bias, y) -> torch.Tensor:
    triton_build_dir()
    from octave_tpu_torch.ops.kernels.triton_bn_act import bn_act_kernel

    c = x.shape[1]
    n = x.numel() // c if c else 0
    if n == 0:
        return y
    block_c = min(next_pow2(c), _MAX_BLOCK_C)
    block_m = _TILE_ELEMS // block_c
    grid = (-(-n // block_m), -(-c // block_c))
    affine = res_scale is not None
    bn_act_kernel[grid](
        x, scale, bias, x if residual is None else residual,
        res_scale if affine else scale, res_bias if affine else bias, y, n, c,
        RESIDUAL=residual is not None, RES_AFFINE=affine,
        BLOCK_M=block_m, BLOCK_C=block_c, num_warps=_NUM_WARPS,
    )
    count_launch(fused_bn_act)
    return y


def fused_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 res_scale: Optional[torch.Tensor] = None,
                 res_bias: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """See the module docstring: one launch of the Triton kernel (counted
    in `fused_bn_act.launches`), y in x's dtype and channels-last layout,
    written into `out` (x itself may be given, and the residual may be x:
    each element is read before it is written) or a new tensor. Eval only:
    no gradient. Raises a ValueError on inputs `takes` refuses, on an `out`
    of another shape, dtype, device or layout, and off CUDA (the plain
    version is `fused_bn_act_plain`)."""
    args = (x, scale, bias, residual, res_scale, res_bias)
    if not takes(*args):
        raise ValueError(
            f"fused_bn_act: x {tuple(x.shape)} {x.dtype} strides {x.stride()} with "
            f"scale, bias, residual and its affine as given is not a channels-last "
            f"activation with (C,) affines and a residual of its shape and dtype, "
            f"free of gradients")
    if out is None:
        out = torch.empty_like(x)  # x's channels-last strides
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or out.stride() != x.stride()):
        raise ValueError(f"fused_bn_act: out {tuple(out.shape)} {out.dtype} strides "
                         f"{out.stride()} on {out.device} is not laid out as x")
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_act: the kernel runs on CUDA, not on {x.device}")
    return _launch(*args, out)


fused_bn_act = register_counter("bn_act", fused_bn_act)
