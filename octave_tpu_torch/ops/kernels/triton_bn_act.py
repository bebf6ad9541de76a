"""Triton source of the fused eval batch norm, residual join and ReLU.

Imported only by `bn_act.py::_launch`, never at package import: it needs
the `triton` package and a CUDA device. See bn_act.py for the design note.
"""
import triton
import triton.language as tl


@triton.jit
def bn_act_kernel(x_ptr, s_ptr, b_ptr, r_ptr, rs_ptr, rb_ptr, y_ptr, n_rows, C,
                  RESIDUAL: tl.constexpr, RES_AFFINE: tl.constexpr,
                  BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program (m, c) finishes a [BLOCK_M, BLOCK_C] tile of the (n_rows, C)
    row-major matrix that a channels-last activation is.

    The per-channel affines are read once per program. Each affine and
    the join is a float32 operation rounded to the storage dtype where the
    plain chain stores it: x * s + b and r * rs + rb as one fused
    multiply-add each, as `addcmul` computes them on the card (in bf16 and
    float16 the product is exact, so only the float32 result depends on
    it), their sum, then the ReLU, which keeps a NaN as `clamp_min` does."""
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    col_ok = cols < C
    ok = (rows < n_rows)[:, None] & col_ok[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    dt = y_ptr.dtype.element_ty

    s = tl.load(s_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
    y = tl.fma(x, tl.broadcast_to(s[None, :], (BLOCK_M, BLOCK_C)),
               tl.broadcast_to(b[None, :], (BLOCK_M, BLOCK_C))).to(dt)
    if RESIDUAL:
        r = tl.load(r_ptr + offs, mask=ok, other=0.0)
        if RES_AFFINE:
            rs = tl.load(rs_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
            rb = tl.load(rb_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
            r = tl.fma(r.to(tl.float32), tl.broadcast_to(rs[None, :], (BLOCK_M, BLOCK_C)),
                       tl.broadcast_to(rb[None, :], (BLOCK_M, BLOCK_C))).to(dt)
        y = (y.to(tl.float32) + r.to(tl.float32)).to(dt)
    y = tl.where(y < 0, 0.0, y).to(dt)
    tl.store(y_ptr + offs, y, mask=ok)
