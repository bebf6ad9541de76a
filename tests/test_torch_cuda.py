"""The port's Triton kernels against their plain PyTorch versions, on a GPU.

Every case skips without CUDA. The file imports neither JAX nor the JAX
package, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: `kernel_tolerance`, the table chip_smoke.py uses too: float32
as tests/test_pallas_kernels.py (the same formula in another summation
order), scaled by sqrt(C / 64) above C = 64; bfloat16 one bf16 ulp of the
plain result (rtol 2^-7) plus 1e-3 (atol), because kernel and plain version
both compute in float32 and round once, and can fall on either side of a
rounding boundary.
"""
import numpy as np
import pytest
import torch

from octave_tpu_torch.ops.kernels import kernel_tolerance
from octave_tpu_torch.ops.kernels.aag import fused_aag, fused_aag_plain
from octave_tpu_torch.ops.kernels.decoder_epilogue import (
    fused_decoder_epilogue,
    fused_decoder_epilogue_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernels run only there)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(42)


def _t(a, device, dtype):
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, atol_rtol):
    atol, rtol = atol_rtol
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,k", [((2, 19, 19, 32), 2), ((1, 10, 13, 64), 3),
                                     ((3, 7, 7, 8), 2), ((2, 19, 19, 1024), 2),
                                     ((1, 5, 6, 96), 2)])
def test_aag_kernel_matches_plain(cuda, gen, shape, k, dtype):
    x = _t(gen.standard_normal(shape).astype(np.float32), cuda, dtype)
    w = _t((gen.standard_normal((shape[-1], k)) * 0.1).astype(np.float32), cuda, torch.float32)
    b = _t((gen.standard_normal((k,)) * 0.1).astype(np.float32), cuda, torch.float32)
    launches = fused_aag.launches
    out, yhat = fused_aag(x, w, b)
    torch.cuda.synchronize()
    assert fused_aag.launches == launches + 1
    assert out.dtype == yhat.dtype == dtype and yhat.shape == shape[:-1] + (k,)
    ref_out, ref_yhat = fused_aag_plain(x, w, b)
    tol_out, tol_yhat = kernel_tolerance("aag", dtype, shape[-1])
    _close(out, ref_out, tol_out)
    _close(yhat, ref_yhat, tol_yhat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,k", [((2, 8, 10, 16), 2), ((1, 6, 6, 32), 3),
                                     ((2, 19, 19, 1024), 2), ((1, 5, 6, 96), 2)])
def test_decoder_epilogue_kernel_matches_plain(cuda, gen, shape, k, dtype):
    b_, h, w_, c = shape
    z = _t(gen.standard_normal((b_, h, w_, 2 * c)).astype(np.float32), cuda, dtype)
    attn = _t(gen.standard_normal((b_, 2 * c)).astype(np.float32), cuda, torch.float32)
    res = _t(gen.standard_normal((b_, h, w_, c)).astype(np.float32), cuda, dtype)
    rs = _t(gen.uniform(0.5, 2, (c,)).astype(np.float32), cuda, torch.float32)
    rb = _t(gen.uniform(-1, 1, (c,)).astype(np.float32), cuda, torch.float32)
    w = _t((gen.standard_normal((c, k)) * 0.1).astype(np.float32), cuda, torch.float32)
    bb = _t((gen.standard_normal((k,)) * 0.1).astype(np.float32), cuda, torch.float32)
    launches = fused_decoder_epilogue.launches
    out, yhat = fused_decoder_epilogue(z, attn, res, rs, rb, w, bb)
    torch.cuda.synchronize()
    assert fused_decoder_epilogue.launches == launches + 1
    ref_out, ref_yhat = fused_decoder_epilogue_plain(z, attn, res, rs, rb, w, bb)
    tol_out, tol_yhat = kernel_tolerance("decoder_epilogue", dtype, c)
    _close(out, ref_out, tol_out)
    _close(yhat, ref_yhat, tol_yhat)


def test_aag_kernel_backward_matches_plain(cuda, gen):
    """Through the kernel forward, the plain backward gives autograd's
    gradient of the plain formula."""
    x0 = gen.standard_normal((1, 8, 8, 16)).astype(np.float32)
    w0 = (gen.standard_normal((16, 2)) * 0.1).astype(np.float32)
    b0 = (gen.standard_normal((2,)) * 0.1).astype(np.float32)
    grads = []
    for fn in (fused_aag, fused_aag_plain):
        x, w, b = (_t(a, cuda, torch.float32).requires_grad_() for a in (x0, w0, b0))
        out, yhat = fn(x, w, b)
        (torch.sum(out**2) + torch.sum(yhat * torch.cos(yhat))).backward()
        grads.append((x.grad, w.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
