"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_pallas_kernels.py does.
Inputs are made with numpy from a seed and handed to both. Tolerances are
those of tests/test_pallas_kernels.py: the same float32 formula in another
summation order. The kernels themselves are held against these plain
versions on the GPU in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octave_tpu.ops.pallas.aag import fused_aag as jax_fused_aag
from octave_tpu.ops.pallas.decoder_epilogue import (
    fused_decoder_epilogue as jax_fused_decoder_epilogue,
)
from octave_tpu_torch.ops.kernels.aag import fused_aag
from octave_tpu_torch.ops.kernels.decoder_epilogue import fused_decoder_epilogue


def _aag_inputs(rng, shape, k):
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], k)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((k,)) * 0.1).astype(np.float32)
    return x, w, b


def _epilogue_inputs(rng, shape, k):
    b_, h, w_, c = shape
    return (
        rng.standard_normal((b_, h, w_, 2 * c)).astype(np.float32),
        rng.standard_normal((b_, 2 * c)).astype(np.float32),
        rng.standard_normal((b_, h, w_, c)).astype(np.float32),
        rng.uniform(0.5, 2, (c,)).astype(np.float32),
        rng.uniform(-1, 1, (c,)).astype(np.float32),
        (rng.standard_normal((c, k)) * 0.1).astype(np.float32),
        (rng.standard_normal((k,)) * 0.1).astype(np.float32),
    )


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (2,19,19,32) k=2 and (1,10,13,64) k=3 are test_pallas_kernels' cases;
# 3*7*7 = 147 rows is its case of rows that are not a multiple of a tile
@pytest.mark.parametrize("shape,k", [((2, 19, 19, 32), 2), ((1, 10, 13, 64), 3),
                                     ((3, 7, 7, 8), 2)])
def test_aag_matches_pallas(rng, shape, k):
    x, w, b = _aag_inputs(rng, shape, k)
    ref_out, ref_yhat = jax_fused_aag(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    launches = fused_aag.launches
    out, yhat = fused_aag(*_torch(x, w, b))
    assert fused_aag.launches == launches, "a CPU tensor must not launch the kernel"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(yhat.numpy(), np.asarray(ref_yhat), atol=1e-6)


def test_aag_grad_matches_jax_grad(rng):
    shape, k = (1, 8, 8, 16), 2
    x, w, b = _aag_inputs(rng, shape, k)

    def loss_jax(x, w, b):
        out, yhat = jax_fused_aag(x, w, b)
        return jnp.sum(out**2) + jnp.sum(yhat * jnp.cos(yhat))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (t.requires_grad_() for t in _torch(x, w, b))
    out, yhat = fused_aag(xt, wt, bt)
    (torch.sum(out**2) + torch.sum(yhat * torch.cos(yhat))).backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_aag_rejects_bad_input(rng):
    x, w, b = _torch(*_aag_inputs(rng, (1, 4, 4, 8), 2))
    with pytest.raises(ValueError):
        fused_aag(x.permute(0, 3, 1, 2), w, b)  # NCHW strides, not NHWC
    with pytest.raises(ValueError):
        fused_aag(x, w[:4], b)
    with pytest.raises(TypeError):  # float16 is a kernel dtype, int32 is not
        fused_aag(x.to(torch.int32), w, b)


@pytest.mark.parametrize("shape,k", [((2, 8, 10, 16), 2), ((1, 6, 6, 32), 3)])
def test_decoder_epilogue_matches_pallas(rng, shape, k):
    args = _epilogue_inputs(rng, shape, k)
    ref_out, ref_yhat = jax_fused_decoder_epilogue(*[jnp.asarray(a) for a in args])
    launches = fused_decoder_epilogue.launches
    out, yhat = fused_decoder_epilogue(*_torch(*args))
    assert fused_decoder_epilogue.launches == launches
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(yhat.numpy(), np.asarray(ref_yhat), atol=1e-5)


def test_decoder_epilogue_rejects_bad_input(rng):
    z, attn, res, rs, rb, w, b = _torch(*_epilogue_inputs(rng, (1, 4, 4, 8), 2))
    with pytest.raises(ValueError):
        fused_decoder_epilogue(z[..., :8].contiguous(), attn, res, rs, rb, w, b)
    with pytest.raises(ValueError):
        fused_decoder_epilogue(z, attn[:, :8], res, rs, rb, w, b)
    with pytest.raises(ValueError):
        fused_decoder_epilogue(z, attn, res.permute(0, 3, 1, 2), rs, rb, w, b)


def test_recorded_launches_count_once_per_replay():
    """Inside `record_launches` (a CUDA-graph capture, whose kernels do not
    run) a launch goes to the tally; each replay adds the tally once."""
    from octave_tpu_torch.ops import kernels

    class Wrapper:
        launches = 0

    w = Wrapper()
    kernels.count_launch(w)
    with kernels.record_launches() as tally:
        kernels.count_launch(w)
        kernels.count_launch(w)
        with pytest.raises(RuntimeError, match="already"):
            with kernels.record_launches():
                pass
    assert w.launches == 1 and tally == {w: 2}
    kernels.add_launches(tally)
    kernels.add_launches(tally)
    kernels.count_launch(w)
    assert w.launches == 6

