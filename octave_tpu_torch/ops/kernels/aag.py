"""Fused Adversarial Attention Gate: a Triton kernel and its plain version.

Replaces the Pallas kernel `octave_tpu/ops/pallas/aag.py::fused_aag`
(`_kernel` :45-60, `pallas_call` :97). For x (B,H,W,C), W (C,K), b (K):
    logits = x·W + b;  y_hat = softmax(logits) over K;  mask = Σ_{k≥1} y_hat
    returns (x * mask, y_hat).

Bound on the H100: memory. Per pixel the gate reads C activation values and
writes C + K; with K = 2 that is about 5C flops for 4C bytes in bf16, far
under the card's ridge of ~295 flops per byte, so the least time
is bytes / 3.35 TB/s (about 8.5 µs of the five 304² decoder depths per image
in bf16, 28.6 MB). What the design does about it: each program keeps a whole
[rows, C] tile in registers, so x is read from device memory exactly once
and written once; the K = 2 logits are two row reductions held in registers
(no padding of K to 128 lanes as the TPU kernel did, which would have
written 64x the y_hat bytes); rows are contiguous NHWC, so every tile load
and store is one coalesced run of memory. K is far below any tensor-core
tile, so no `tl.dot`.

The backward (`_AAGFunction.backward`) is plain PyTorch reproducing the JAX
package's XLA backward (`aag.py:_bwd` :126-142).
"""
from __future__ import annotations

from typing import Tuple

import torch

from octave_tpu_torch.ops.kernels import (
    check_nhwc,
    count_launch,
    next_pow2,
    pow2_tile,
    register_counter,
    triton_build_dir,
)

# register tile of one program: rows x next_pow2(C) values
_TILE_ELEMS = 4096


def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input (a CPU reference run)."""
    return torch.promote_types(x.dtype, torch.float32)


def fused_aag_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    yhat_dtype: torch.dtype | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager formula, in float32 (float64 for float64 x), cast back to
    x's dtype (y_hat to `yhat_dtype` when given)."""
    ct = _math_dtype(x)
    xf = x.to(ct)
    yhat = torch.softmax(xf @ w.to(ct) + b.to(ct), dim=-1)
    mask = yhat[..., 1:].sum(dim=-1, keepdim=True)
    return (xf * mask).to(x.dtype), yhat.to(yhat_dtype or x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
            yhat_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    triton_build_dir()
    from octave_tpu_torch.ops.kernels.triton_aag import aag_fwd_kernel

    c, k = w.shape
    n = x.numel() // c
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    yhat = torch.empty(x.shape[:-1] + (k,), dtype=yhat_dtype, device=x.device)
    block_n, block_c = pow2_tile(c, _TILE_ELEMS)
    grid = (-(-n // block_n),)
    aag_fwd_kernel[grid](
        x, w.float().contiguous(), b.float().contiguous(), out, yhat, n,
        C=c, K=k, BLOCK_N=block_n, BLOCK_C=block_c, BLOCK_K=next_pow2(k),
        num_warps=4,
    )
    count_launch(fused_aag)
    return out, yhat


class _AAGFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, autocast_dtype):
        # under autocast the gate computes on x rounded to the autocast dtype
        # (the kernel rounds it as it loads x, so x is read once); the
        # backward reads x itself
        out_dtype, yhat_dtype = x.dtype, x.dtype
        if autocast_dtype is not None:
            out_dtype, yhat_dtype = autocast_dtype, torch.float32
        if x.is_cuda:
            out, yhat = _launch(x, w, b, out_dtype, yhat_dtype)
        else:
            out, yhat = fused_aag_plain(x.to(out_dtype), w, b, yhat_dtype)
        ctx.save_for_backward(x, w, yhat)
        ctx.b_dtype = b.dtype
        return out, yhat

    @staticmethod
    def backward(ctx, g_out, g_yhat):
        # in float32 (float64 for float64 x) whatever x's dtype: a bf16 x
        # gets its g_x in bf16 and float32 g_w, g_b summed over every pixel
        x, w, yhat = ctx.saved_tensors
        ct = _math_dtype(x)
        xf, yhat, g_out, g_yhat = (t.to(ct) for t in (x, yhat, g_out, g_yhat))
        mask = yhat[..., 1:].sum(dim=-1, keepdim=True)
        dmask = (g_out * xf).sum(dim=-1, keepdim=True)
        # 0 for the background class, 1 for the others (made on the device:
        # a captured step copies nothing from the host)
        sel = (torch.arange(yhat.shape[-1], device=yhat.device) > 0).to(ct)
        ghat = g_yhat + dmask * sel
        g_z = yhat * (ghat - (ghat * yhat).sum(dim=-1, keepdim=True))
        g_x = (g_out * mask + g_z @ w.to(ct).t()).to(x.dtype)
        g_w = (xf.reshape(-1, x.shape[-1]).t() @ g_z.reshape(-1, g_z.shape[-1])).to(w.dtype)
        g_b = g_z.reshape(-1, g_z.shape[-1]).sum(dim=0).to(ctx.b_dtype)
        return g_x, g_w, g_b, None


def fused_aag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              autocast_dtype: torch.dtype | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,H,W,C) contiguous NHWC; w (C,K); b (K,) -> (x*mask, y_hat (B,H,W,K)),
    both in x's dtype. With `autocast_dtype` (the train path under autocast)
    the gate computes on x rounded to that dtype and writes x*mask in it
    (what `fused_aag_plain(x.to(autocast_dtype), ...)` gives), y_hat stays
    float32 (the kernel computes it in float32 either way), and the gradient
    of x comes back in x's dtype, computed from x itself.

    On a CUDA tensor it launches the Triton kernel (and counts the launch in
    `fused_aag.launches`); on a CPU tensor it runs `fused_aag_plain`, which
    also takes float64 for reference runs. It is differentiable on both."""
    cpu_f64 = (torch.float64,) if x.device.type == "cpu" else ()
    check_nhwc("x", x, 4, x.device, (torch.float32, torch.bfloat16, torch.float16) + cpu_f64)
    if w.ndim != 2 or w.shape[0] != x.shape[-1] or b.shape != (w.shape[1],):
        raise ValueError(f"w must be (C, K) and b (K,) for C={x.shape[-1]}; got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_aag: no implementation for device {x.device}")
    if autocast_dtype not in (None, torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"fused_aag: unsupported autocast dtype {autocast_dtype}")
    return _AAGFunction.apply(x, w, b, autocast_dtype)


fused_aag = register_counter("aag", fused_aag)
