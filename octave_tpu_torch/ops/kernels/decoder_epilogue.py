"""Fused decoder-block epilogue (eval only): a Triton kernel and its plain version.

Replaces the Pallas kernel
`octave_tpu/ops/pallas/decoder_epilogue.py::fused_decoder_epilogue`
(`_kernel` :45-91, `pallas_call` :131). Inputs:
    z    (B,H,W,2C)  split-attention conv output after BN0 + ReLU
    attn (B,2C)      fc2 logits, laid out [radix-0 channels, radix-1 channels]
    res  (B,H,W,C)   shortcut conv output, before its BN
    res_scale, res_bias (C,)  the shortcut BN as an eval affine (raw or folded)
    w (C,K), b (K,)  the attention gate's 1x1 conv
computes
    p0, p1 = softmax((attn[:, :C], attn[:, C:])) per channel
    s = p0*z[..., :C] + p1*z[..., C:]
    y = relu(relu(s) + res*res_scale + res_bias)
    y_hat = softmax(y·w + b) over K;  mask = Σ_{k≥1} y_hat
and returns (y * mask, y_hat).

Bound on the H100: memory. Per pixel it reads 3C activation values and
writes C + K, under 2 flops per byte in bf16, far under the card's ridge of
~295 flops per byte; over the five 304² decoder depths that is about 56.7 MB
per image in bf16, 17 µs at 3.35 TB/s. What the design does about it: one
program per (image, tile of pixels) loads attn[b] once, streams z's two
halves and res through registers exactly once as coalesced NHWC runs,
keeps y, the K = 2 logits, the softmax and the mask in registers, and
stores only y*mask and y_hat; the unfused chain would write and re-read s,
y and the gate's intermediates. K stays two row reductions (not padded to
128 lanes as on the TPU), below any tensor-core tile.
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

# register tile of one program: pixels x next_pow2(C); four such tiles live
_TILE_ELEMS = 2048


def fused_decoder_epilogue_plain(z, attn, res, res_scale, res_bias, w, b):
    """The eager formula, in float32, cast back to z's dtype."""
    c = z.shape[-1] // 2
    p = torch.softmax(attn.float().view(z.shape[0], 2, c), dim=1)
    p0 = p[:, 0].view(-1, 1, 1, c)
    p1 = p[:, 1].view(-1, 1, 1, c)
    zf = z.float()
    s = torch.relu(zf[..., :c] * p0 + zf[..., c:] * p1)
    y = torch.relu(s + res.float() * res_scale.float() + res_bias.float())
    yhat = torch.softmax(y @ w.float() + b.float(), dim=-1)
    mask = yhat[..., 1:].sum(dim=-1, keepdim=True)
    return (y * mask).to(z.dtype), yhat.to(z.dtype)


def _launch(z, attn, res, res_scale, res_bias, w, b):
    triton_build_dir()
    from octave_tpu_torch.ops.kernels.triton_decoder_epilogue import (
        decoder_epilogue_kernel,
    )

    bsz, h, wd, c = res.shape
    k = w.shape[1]
    out = torch.empty_like(res, dtype=z.dtype)
    yhat = torch.empty((bsz, h, wd, k), dtype=z.dtype, device=z.device)
    block_p, block_c = pow2_tile(c, _TILE_ELEMS)
    grid = (-(-(h * wd) // block_p), bsz)
    decoder_epilogue_kernel[grid](
        z, attn.float().contiguous(), res, res_scale.float().contiguous(),
        res_bias.float().contiguous(), w.float().contiguous(), b.float().contiguous(),
        out, yhat, h * wd,
        C=c, K=k, BLOCK_P=block_p, BLOCK_C=block_c, BLOCK_K=next_pow2(k),
        num_warps=4,
    )
    count_launch(fused_decoder_epilogue)
    return out, yhat


def fused_decoder_epilogue(
    z: torch.Tensor, attn: torch.Tensor, res: torch.Tensor,
    res_scale: torch.Tensor, res_bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """See the module docstring. z, res contiguous NHWC; returns
    (gated (B,H,W,C), y_hat (B,H,W,K)) in z's dtype. Eval only: no gradient.

    On a CUDA tensor it launches the Triton kernel (and counts the launch in
    `fused_decoder_epilogue.launches`); on a CPU tensor it runs
    `fused_decoder_epilogue_plain`."""
    dev = z.device
    check_nhwc("z", z, 4, dev)
    check_nhwc("res", res, 4, dev)
    bsz, h, wd, c = res.shape
    if z.shape != (bsz, h, wd, 2 * c) or z.dtype != res.dtype:
        raise ValueError(f"z must be {(bsz, h, wd, 2 * c)} {res.dtype}; got "
                         f"{tuple(z.shape)} {z.dtype}")
    if attn.shape != (bsz, 2 * c):
        raise ValueError(f"attn must be {(bsz, 2 * c)}; got {tuple(attn.shape)}")
    if res_scale.shape != (c,) or res_bias.shape != (c,):
        raise ValueError("res_scale and res_bias must be (C,)")
    if w.ndim != 2 or w.shape[0] != c or b.shape != (w.shape[1],):
        raise ValueError(f"w must be (C, K) and b (K,) for C={c}")
    if any(t.device != dev for t in (attn, res_scale, res_bias, w, b)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cuda":
        return _launch(z, attn, res, res_scale, res_bias, w, b)
    if dev.type == "cpu":
        return fused_decoder_epilogue_plain(z, attn, res, res_scale, res_bias, w, b)
    raise ValueError(f"fused_decoder_epilogue: no implementation for device {dev}")


fused_decoder_epilogue = register_counter("decoder_epilogue", fused_decoder_epilogue)
