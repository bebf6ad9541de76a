"""Triton source of the fused decoder-block epilogue (eval only).

Imported only by `decoder_epilogue.py::_launch`, never at package import: it
needs the `triton` package and a CUDA device. See decoder_epilogue.py for the
design note.
"""
import triton
import triton.language as tl

from octave_tpu_torch.ops.kernels.triton_aag import gate_store


@triton.jit
def decoder_epilogue_kernel(z_ptr, attn_ptr, res_ptr, rs_ptr, rb_ptr, w_ptr, b_ptr,
                            out_ptr, yhat_ptr, n_pix,
                            C: tl.constexpr, K: tl.constexpr, BLOCK_P: tl.constexpr,
                            BLOCK_C: tl.constexpr, BLOCK_K: tl.constexpr):
    """Program (p, b) finishes BLOCK_P pixels of image b.

    attn[b] (2C fc2 logits) is read once per program and turned into the
    radix-2 weights p0, p1 in float32. z's two halves and res are read once
    as [BLOCK_P, BLOCK_C] tiles; y, its K logits, the softmax and the mask
    stay in registers; y*mask and y_hat are the only stores."""
    pid_p = tl.program_id(0)
    bi = tl.program_id(1).to(tl.int64)
    pix = pid_p * BLOCK_P + tl.arange(0, BLOCK_P)
    cols = tl.arange(0, BLOCK_C)
    pix_ok = pix < n_pix
    col_ok = cols < C
    tile_ok = pix_ok[:, None] & col_ok[None, :]
    rows = bi * n_pix + pix

    a0 = tl.load(attn_ptr + bi * 2 * C + cols, mask=col_ok, other=0.0)
    a1 = tl.load(attn_ptr + bi * 2 * C + C + cols, mask=col_ok, other=0.0)
    am = tl.maximum(a0, a1)
    e0 = tl.exp(a0 - am)
    e1 = tl.exp(a1 - am)
    p0 = e0 / (e0 + e1)
    p1 = e1 / (e0 + e1)
    rs = tl.load(rs_ptr + cols, mask=col_ok, other=0.0)
    rb = tl.load(rb_ptr + cols, mask=col_ok, other=0.0)

    zoffs = rows[:, None] * (2 * C) + cols[None, :]
    z0 = tl.load(z_ptr + zoffs, mask=tile_ok, other=0.0).to(tl.float32)
    z1 = tl.load(z_ptr + zoffs + C, mask=tile_ok, other=0.0).to(tl.float32)
    offs = rows[:, None] * C + cols[None, :]
    res = tl.load(res_ptr + offs, mask=tile_ok, other=0.0).to(tl.float32)

    s = tl.maximum(z0 * p0[None, :] + z1 * p1[None, :], 0.0)
    y = tl.maximum(s + res * rs[None, :] + rb[None, :], 0.0)

    gate_store(y, w_ptr, b_ptr, out_ptr, yhat_ptr, rows, cols, pix_ok, col_ok,
               C, K, BLOCK_P, BLOCK_K)
