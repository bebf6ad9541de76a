"""Triton source of the fused Adversarial Attention Gate forward.

Imported only by `aag.py::_launch` and by triton_decoder_epilogue.py, which
shares `gate_store`, never at package import: it needs the `triton` package
and a CUDA device. See aag.py for the design note.
"""
import triton
import triton.language as tl


@triton.jit
def gate_store(y, w_ptr, b_ptr, out_ptr, yhat_ptr, rows, cols, row_ok, col_ok,
               C: tl.constexpr, K: tl.constexpr, BLOCK_R: tl.constexpr,
               BLOCK_K: tl.constexpr):
    """The attention gate on a float32 [BLOCK_R, BLOCK_C] tile y of the
    (n, C) activation at `rows`: the K class logits are K row reductions
    against W's columns, the softmax over K and the mask are per-row scalars,
    and y*mask and y_hat (n, K) are stored in the outputs' dtype."""
    kcol = tl.arange(0, BLOCK_K)
    logits = tl.full((BLOCK_R, BLOCK_K), float("-inf"), tl.float32)
    for k in tl.static_range(K):
        wk = tl.load(w_ptr + cols * K + k, mask=col_ok, other=0.0)
        lk = tl.sum(y * wk[None, :], axis=1) + tl.load(b_ptr + k)
        logits = tl.where(kcol[None, :] == k, lk[:, None], logits)
    mx = tl.max(logits, axis=1)
    e = tl.exp(logits - mx[:, None])
    yhat = e / tl.sum(e, axis=1)[:, None]
    mask = tl.sum(tl.where(kcol[None, :] >= 1, yhat, 0.0), axis=1)

    tl.store(out_ptr + rows[:, None] * C + cols[None, :],
             (y * mask[:, None]).to(out_ptr.dtype.element_ty),
             mask=row_ok[:, None] & col_ok[None, :])
    tl.store(yhat_ptr + rows[:, None] * K + kcol[None, :],
             yhat.to(yhat_ptr.dtype.element_ty),
             mask=row_ok[:, None] & (kcol[None, :] < K))


@triton.jit
def aag_fwd_kernel(x_ptr, w_ptr, b_ptr, out_ptr, yhat_ptr, n_rows,
                   C: tl.constexpr, K: tl.constexpr, BLOCK_N: tl.constexpr,
                   BLOCK_C: tl.constexpr, BLOCK_K: tl.constexpr):
    """One program gates BLOCK_N rows of the (n_rows, C) activation.

    The [BLOCK_N, BLOCK_C] tile is loaded once and stays in registers through
    the gate (`gate_store`). It is rounded to the dtype of x*mask first, so
    that a float32 x gated in bf16 or float16 (under autocast) is read once,
    as the rounded copy would be; for x in that dtype the rounding is none."""
    pid = tl.program_id(0)
    rows = pid.to(tl.int64) * BLOCK_N + tl.arange(0, BLOCK_N)
    cols = tl.arange(0, BLOCK_C)
    row_ok = rows < n_rows
    col_ok = cols < C
    x = tl.load(x_ptr + rows[:, None] * C + cols[None, :],
                mask=row_ok[:, None] & col_ok[None, :], other=0.0)
    x = x.to(out_ptr.dtype.element_ty).to(tl.float32)
    gate_store(x, w_ptr, b_ptr, out_ptr, yhat_ptr, rows, cols, row_ok, col_ok,
               C, K, BLOCK_N, BLOCK_K)
