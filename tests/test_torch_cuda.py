"""The port's Triton kernels and its CUDA C++ int8 conv kernel against their
plain PyTorch versions, its int8 convs against the CPU's, its deployment
path (augmentation, checkpoints, the pipelined server, the int8 Predictor),
the gated dual decoders with their two critics and the train step captured
as a CUDA graph, on a GPU.

Every case skips without CUDA. The file imports neither JAX nor the JAX
package, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: `kernel_tolerance`, the table chip_smoke.py uses too: float32
as tests/test_pallas_kernels.py (the same formula in another summation
order), scaled by sqrt(C / 64) above C = 64; bfloat16 one bf16 ulp of the
plain result (rtol 2^-7) plus 1e-3 (atol), because kernel and plain version
both compute in float32 and round once, and can fall on either side of a
rounding boundary; float16 likewise one float16 ulp (rtol 2^-10) plus 1e-3.
The int8 conv kernel is held bit for bit: it rounds where its plain version
rounds (true-division quantisation, exact int32 sums, float32 dequantisation
without contraction, one cast). So is the fused batch norm (`bn_act`): it
rounds where the plain chain stores, and each affine is one fused
multiply-add, as `addcmul`'s is.
"""
import json

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
        pytest.skip("needs a CUDA device (the kernels run only there)")
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 19, 19, 1024), (2, 38, 38, 32)])
def test_aag_kernel_backward_in_train_dtypes(cuda, gen, shape, dtype):
    """The train step's use: x in float32 or bf16 (autocast), w and b float32
    master weights. g_x comes back in x's dtype, g_w and g_b in float32, all
    near the float64 gradient of the plain formula: 1e-4 of each gradient's
    largest entry in float32, 2^-5 in bf16 (y_hat is kept in bf16 from
    forward to backward, and g_w, g_b sum cancelling terms over every
    pixel)."""
    x0 = gen.standard_normal(shape).astype(np.float32)
    w0 = (gen.standard_normal((shape[-1], 2)) * 0.1).astype(np.float32)
    b0 = (gen.standard_normal((2,)) * 0.1).astype(np.float32)
    g_out = _t(gen.standard_normal(shape).astype(np.float32), cuda, dtype)
    g_yhat = _t(gen.standard_normal(shape[:-1] + (2,)).astype(np.float32), cuda, dtype)
    x = _t(x0, cuda, dtype).requires_grad_()
    w, b = (_t(a, cuda, torch.float32).requires_grad_() for a in (w0, b0))
    out, yhat = fused_aag(x, w, b)
    torch.autograd.backward((out, yhat), (g_out, g_yhat))
    assert x.grad.dtype == dtype and w.grad.dtype == b.grad.dtype == torch.float32
    ref = [_t(a, cuda, dtype).double().requires_grad_() for a in (x0, w0, b0)]
    ref_out, ref_yhat = fused_aag_plain(*ref)
    torch.autograd.backward((ref_out, ref_yhat), (g_out.double(), g_yhat.double()))
    share = 1e-4 if dtype == torch.float32 else 2**-5
    for got, want in zip((x.grad, w.grad, b.grad), (r.grad for r in ref)):
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=share * float(want.abs().max()))


@pytest.mark.parametrize("stride,hw", [(2, 20), (2, 19), (1, 10)])
def test_bottleneck_gradient_on_card(cuda, stride, hw):
    """A ResNeSt bottleneck in training mode, channels_last, float32 with
    TF32 off, gives the CPU float64 gradients. Before `ops.common.avg_pool2d`
    pooled an NCHW copy under autograd, torch's CUDA backward of the
    pad-counting avd pool over channels_last returned input gradients ~100%
    off in the strided blocks (stride 2), and so did every layer before it."""
    from octave_tpu_torch.models.resnest import Bottleneck

    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cin = 64
        x0 = torch.randn(4, cin, hw, hw, dtype=torch.float64)
        grads = {}
        for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
            torch.manual_seed(1)
            m = Bottleneck(cin, 32, stride, has_downsample=True).to(dev, dt).train()
            m = m.to(memory_format=torch.channels_last)
            x = x0.to(dev, dt).contiguous(memory_format=torch.channels_last).requires_grad_()
            out = m(x)
            r = torch.randn(out.shape, generator=torch.Generator().manual_seed(2),
                            dtype=torch.float64)
            (out * r.to(dev, dt)).sum().backward()
            grads[dev] = [x.grad] + [p.grad for n, p in m.named_parameters()
                                     if not n.endswith("fc1.bias")]  # exact gradient 0
        for got, want in zip(grads["cuda"], grads["cpu"]):
            err = float((got.double().cpu() - want).norm() / want.norm())
            assert err < 1e-3, err
    finally:
        torch.backends.cudnn.allow_tf32 = True


# -- the deployment path on the card -------------------------------------------
def _small_trainer(device, **extra):
    from octave_tpu_torch.train.trainer import Trainer
    from octave_tpu_torch.utils.config import Config

    cfg = Config().apply_overrides({
        "data.image_size": "[64,64]", "data.synthetic_n": "4", "data.batch_size": "2",
        "model.num_filters": "8", "train.steps": "2", "train.eval_every": "0",
        "train.log_every": "0", **extra})
    return Trainer(cfg, device=device)


def test_augmentation_on_card_equals_cpu(cuda, gen):
    """The same draws give the same batch on the card and on the CPU, in
    contiguous NHWC; a CUDA generator draws on the card."""
    from octave_tpu_torch.data import augment
    from octave_tpu_torch.data.preprocess import prepare_batch

    image = gen.integers(0, 256, (4, 40, 40), dtype=np.uint8)
    scrib = gen.integers(0, 3, (4, 40, 40)).astype(np.uint8)
    mask = gen.integers(0, 2, (4, 40, 40)).astype(np.uint8)
    draws = augment.draw(torch.Generator(device=cuda).manual_seed(3), 4, 0.1)
    assert all(t.is_cuda for t in draws)
    on_card = prepare_batch(image, scrib, mask, size=(32, 32), depth=2,
                            augment_draws=draws, device=cuda)
    on_cpu = prepare_batch(image, scrib, mask, size=(32, 32), depth=2,
                           augment_draws=augment.Draws(*(t.cpu() for t in draws)), device="cpu")
    for k in ("image", "scribble_onehot", "mask_onehot"):
        assert on_card[k].is_cuda and on_card[k].is_contiguous()
        torch.testing.assert_close(on_card[k].cpu(), on_cpu[k], atol=2e-6, rtol=0)
    for a, b in zip(on_card["mask_pyramid"], on_cpu["mask_pyramid"]):
        assert torch.equal(a.cpu(), b)
    again = augment.draw(torch.Generator(device=cuda).manual_seed(3), 4, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """Restored parameters, fused Adam moments and step counters lie on the
    card in the parameters' layout, bit-equal to the live state, and the next
    step of both states gives the same losses."""
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.train.trainer import build_dataset
    from octave_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict

    tr = _small_trainer(cuda)
    live = tr.fit()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(live.step, live)
    restored = mgr.restore_latest(tr.init_state())
    mgr.close()
    assert restored.step == live.step == 2

    def leaves(obj, path=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, obj

    want, got = dict(leaves(state_to_dict(live))), dict(leaves(state_to_dict(restored)))
    assert want.keys() == got.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert got[k].device == v.device and got[k].stride() == v.stride(), k
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    moments = restored.seg_opt.opt.state_dict()["state"][0]
    assert moments["exp_avg"].is_cuda and moments["step"].is_cuda
    batch = tr.device_batch(next(ds.batch_iterator(build_dataset(tr.cfg), 2, seed=1)))
    a, b = tr.train_step(live, batch), tr.train_step(restored, batch)
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=1e-5)


def test_batch_server_on_card(cuda, gen):
    """The server's answers equal Predictor.__call__'s, in order; every
    dispatched batch launches the epilogue kernel 5 times and the fused
    batch norm 82 times (its sites); host arrays come back in pinned
    memory; the staging buffers are pinned."""
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import BatchServer, Predictor

    pred = Predictor.initialize(image_hw=(64, 64), device=cuda)
    imgs = [gen.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(21)]
    padded = np.zeros((24, 64, 64, 3), np.uint8)
    padded[:21] = np.stack(imgs)
    want = np.concatenate([pred(padded[i:i + 4]) for i in range(0, 24, 4)])[:21]
    ks = []
    dispatch = pred.predict_many_device
    pred.predict_many_device = lambda stack: (ks.append(stack.shape[0]), dispatch(stack))[1]
    with BatchServer(pred, batch=4, image_hw=(64, 64), ks=(1, 2, 4)) as srv:
        assert torch.from_numpy(srv._staging.queue[0]).is_pinned()
        ks.clear()
        launch_counts(reset=True)
        got = list(srv.map(iter(imgs)))
    torch.cuda.synchronize()
    assert launch_counts() == {"aag": 0, "bn_act": 82 * sum(ks),
                               "decoder_epilogue": 5 * sum(ks), "int8_conv": 0}
    assert sum(ks) * 4 >= 21 and len(got) == 21
    assert torch.from_numpy(got[0]).is_pinned()
    np.testing.assert_allclose(np.stack(got), want, atol=2**-7, rtol=0)


# -- the rest of the model family on the card ----------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["aag", "fused"])
def test_gated_dual_decoders_on_card(cuda, gen, fused):
    """Seven gates at gating level 4: seven launches of the kernel in use per
    eval forward, and the float32 outputs (TF32 off) of the CPU forward."""
    from octave_tpu_torch.models.segmentor import ResnestUnetParallelHeadAttentionGate
    from octave_tpu_torch.ops.kernels import launch_counts

    torch.manual_seed(0)
    model = ResnestUnetParallelHeadAttentionGate(2, 4, use_fused_decoder=fused).eval()
    x = torch.from_numpy(gen.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        (_, _), want = model.to(memory_format=torch.channels_last)(x)
        model = model.to(cuda)
        torch.backends.cudnn.allow_tf32 = False
        try:
            launch_counts(reset=True)
            (atts, atts_c), got = model(x.to(cuda))
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = True
    kernel = "decoder_epilogue" if fused else "aag"
    assert launch_counts() == {"aag": 0, "bn_act": 0, "decoder_epilogue": 0, "int8_conv": 0,
                               kernel: 7}  # unfolded norms: no fused batch norm
    assert len(atts) == 5 and len(atts_c) == 2
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_dual_critic_step_on_card(cuda):
    """One parallel_head_gate train step with both critics: 7 AAG launches,
    finite losses, both critics' u/v stored."""
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.train.trainer import build_dataset

    tr = _small_trainer(cuda, **{"model.architecture": "parallel_head_gate"})
    state = tr.init_state()
    u = {n: c.spectral_dict["spectral_0"][0].weight_u.clone() for n, c in state.critic.items()}
    batch = tr.device_batch(next(ds.batch_iterator(build_dataset(tr.cfg), 2, seed=0)))
    launch_counts(reset=True)
    losses = tr.train_step(state, batch)
    torch.cuda.synchronize()
    assert launch_counts() == {"aag": 7, "bn_act": 0, "decoder_epilogue": 0, "int8_conv": 0}
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    for n, c in state.critic.items():
        assert not torch.equal(u[n], c.spectral_dict["spectral_0"][0].weight_u), n


def test_native_loader_beside_a_cuda_step(cuda, tmp_path):
    """A ROSE tree of the committed TIFF fixtures, read through the native
    loader, feeds a train step on the card: 5 AAG launches, finite losses."""
    import shutil
    from pathlib import Path

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.data import native
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.train.trainer import build_dataset

    assert native.available(), native.build_error()
    fixtures = Path(__file__).resolve().parent / "torch_fixtures"
    names = ["gray_none", "gray_lzw", "gray_packbits", "gray_deflate_pred2"]
    for split in ("train", "test"):
        for d in ("img", "gt", "thin_gt"):
            (tmp_path / "ROSE-1" / "SVC" / split / d).mkdir(parents=True)
            for n in names:
                shutil.copy(fixtures / f"{n}.tif", tmp_path / "ROSE-1" / "SVC" / split / d)
    tr = _small_trainer(cuda, **{"data.dataset": "rose", "data.root": str(tmp_path),
                                 "data.image_size": "[64,64]"})
    host = next(ds.batch_iterator(build_dataset(tr.cfg), 2, seed=0))
    assert host["image"].shape == (2, 64, 64)
    state = tr.init_state()
    launch_counts(reset=True)
    losses = tr.train_step(state, tr.device_batch(host))
    torch.cuda.synchronize()
    assert launch_counts()["aag"] == 5
    assert all(bool(torch.isfinite(v)) for v in losses.values())


def test_world_one_nccl_step_equals_one_device(cuda):
    """A data-parallel step as the one rank of an NCCL group (synchronised
    BN, all-reduced gradients and losses) against the same step without a
    group, float32 with TF32 off, at 304², B = 8: losses within 1e-4
    relative. (At 64², B = 2 the deepest BN normalises 8 values per channel
    and float32 rounding alone moves loss_adv by 1e-3.)"""
    import socket

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.parallel import ddp
    from octave_tpu_torch.train.trainer import build_dataset

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    ddp.init_distributed("nccl", f"tcp://127.0.0.1:{port}", 0, 1)
    try:
        quiet = {"model.instance_noise": "false", "model.label_noise": "false",
                 "data.image_size": "[304,304]", "data.synthetic_n": "8",
                 "data.batch_size": "8"}
        one = _small_trainer(cuda, **quiet)
        dp = _small_trainer(cuda, **quiet, **{"train.data_parallel": "true"})
        host = next(ds.batch_iterator(build_dataset(one.cfg), 8, seed=0))
        l_one = one.train_step(one.init_state(), one.device_batch(host))
        l_dp = dp.train_step(dp.init_state(), dp.device_batch(*dp.shard(host)))
        for k, v in l_one.items():
            assert abs(float(l_dp[k]) / float(v) - 1) <= 1e-4, k
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.allow_tf32 = tf32


# (C_in, C_out, kernel, stride, padding, groups, B, H = W): the decoder's
# shapes and the ones CUDA's _int_mm takes only padded: a SplAt fc on
# (B, C, 1, 1) at B <= 16, the stem's C_in = 3 (K = 27), the final fc's
# N = 2
INT8_CONVS = [(64, 32, 3, 1, 1, 1, 2, 38), (32, 64, 3, 1, 1, 4, 2, 19),
              (32, 64, 1, 1, 0, 2, 1, 1), (32, 64, 1, 1, 0, 2, 8, 1),
              (3, 32, 3, 2, 1, 1, 2, 20), (32, 2, 1, 1, 0, 1, 2, 16)]


@pytest.mark.parametrize("case", INT8_CONVS, ids=lambda c: "x".join(map(str, c)))
def test_int8_conv_on_card_equals_cpu(cuda, gen, case):
    """The int8 conv on the card (the int8 conv kernel, one launch, no
    library int8 GEMM) equals the CPU's, bit for bit, in bf16: the same
    quantisation, exact int32 products, the same float32 dequantisation."""
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels.int8_conv import int8_conv_nhwc

    ci, co, k, s, p, g, b, hw = case
    x = _t(gen.standard_normal((b, hw, hw, ci)).astype(np.float32), "cpu", torch.bfloat16)
    x = x.permute(0, 3, 1, 2)
    w = _t((gen.standard_normal((co, ci // g, k, k)) * 0.1).astype(np.float32), "cpu",
           torch.bfloat16)
    bias = _t(gen.standard_normal(co).astype(np.float32), "cpu", torch.bfloat16)
    sx = float(x.float().abs().max()) / 127
    want = quant.int8_conv(x, w, bias, sx, s, p, 1, g)
    calls, gemms = int8_conv_nhwc.launches, quant.int8_mm.launches
    got = quant.int8_conv(x.to(cuda), w.to(cuda), bias.to(cuda), sx, s, p, 1, g)
    assert int8_conv_nhwc.launches == calls + 1 and quant.int8_mm.launches == gemms
    assert torch.equal(got.cpu(), want)


# the int8 conv kernel against its plain version on the card: (name, C_in,
# C_out, kernel, stride, padding, groups, B, H = W, pair C_in, transpose,
# the path the shape selects). Ragged M (< 17 rows), N (13, 200: not a
# multiple of the tile) and K (C_in 12, 3, 40), the pair and the
# ConvTranspose store modes, the halo path (3x3, stride 1, C_in % 32 == 0,
# N < 128: tiles of 16 columns and of whole rows of 19, 38 and 5 pixels,
# ragged column tiles at 100, pairs of 32 and 64 channels; 38 and 76
# columns at N >= 128 now take the wide path), the per-tap path where the
# halo does not apply (2x2) or would not fit (W = 1), decoder_0's two 3x3
# convs at 304², and the wide halo path (wgmma) at the decoder's seven
# sites with N >= 128 (depth 1's conv.3.conv, depths 2-4's pair conv.0 and
# conv.3.conv; 19 x 19 with its ragged last tile) at batches whose tiles
# outnumber an H100's 132 SMs (a block walks several tiles), a ragged N
# (200 of two 128-wide tiles), a pair of unequal halves, and either side of
# the selection's boundary at one shape (N 120 and 128: the wide path takes
# N >= 128 at any batch)
INT8_KERNEL_CASES = [
    ("3x3", 16, 24, 3, 1, 1, 1, 2, 9, None, False, "tap"),
    ("1x1", 16, 24, 1, 1, 0, 1, 2, 9, None, False, "tap"),
    ("stride2", 16, 24, 3, 2, 1, 1, 2, 9, None, False, "tap"),
    ("groups4", 16, 24, 3, 1, 1, 4, 2, 8, None, False, "tap"),
    ("cin3", 3, 32, 3, 2, 1, 1, 2, 10, None, False, "tap"),
    ("fc_m2", 32, 64, 1, 1, 0, 2, 2, 1, None, False, "tap"),
    ("fc_m16", 32, 64, 1, 1, 0, 2, 16, 1, None, False, "tap"),
    ("ragged_nk", 12, 13, 3, 1, 1, 1, 3, 7, None, False, "tap"),
    ("ragged_wide", 40, 200, 3, 1, 1, 1, 2, 13, None, False, "tap"),
    ("pair", 32, 32, 3, 1, 1, 1, 2, 19, 32, False, "halo"),
    ("pair_ragged", 8, 24, 3, 1, 1, 1, 2, 6, 16, False, "tap"),
    ("pair_1x1", 64, 128, 1, 1, 0, 1, 2, 19, 64, False, "tap"),
    ("transpose", 16, 8, 2, 2, 0, 1, 2, 5, None, True, "tap"),
    ("transpose_wide", 256, 64, 2, 2, 0, 1, 2, 38, None, True, "tap"),
    ("halo_w19", 32, 64, 3, 1, 1, 4, 2, 19, None, False, "halo"),
    ("halo_w38", 64, 128, 3, 1, 1, 1, 2, 38, None, False, "wgmma"),
    ("halo_c96_w76", 96, 200, 3, 1, 1, 1, 1, 76, None, False, "wgmma"),
    ("halo_w100", 128, 24, 3, 1, 1, 1, 1, 100, None, False, "halo"),
    ("halo_w5", 32, 40, 3, 1, 1, 1, 3, 5, None, False, "halo"),
    ("per_tap_2x2", 32, 32, 2, 1, 0, 1, 2, 9, None, False, "tap"),
    ("halo_pair_mixed", 32, 48, 3, 1, 1, 1, 2, 21, 64, False, "halo"),
    ("per_tap_w1", 32, 32, 3, 1, 1, 1, 2, 1, None, False, "tap"),
    ("decoder0_conv0", 32, 32, 3, 1, 1, 1, 2, 304, 32, False, "halo"),
    ("decoder0_splat", 32, 64, 3, 1, 1, 4, 2, 304, None, False, "halo"),
    ("decoder1_splat", 64, 128, 3, 1, 1, 4, 1, 152, None, False, "wgmma"),
    ("decoder2_conv0", 256, 256, 3, 1, 1, 1, 3, 76, 256, False, "wgmma"),
    ("decoder2_splat", 256, 512, 3, 1, 1, 4, 2, 76, None, False, "wgmma"),
    ("decoder3_conv0", 512, 512, 3, 1, 1, 1, 6, 38, 512, False, "wgmma"),
    ("decoder3_splat", 512, 1024, 3, 1, 1, 4, 3, 38, None, False, "wgmma"),
    ("decoder4_conv0", 1024, 1024, 3, 1, 1, 1, 11, 19, 1024, False, "wgmma"),
    ("decoder4_splat", 1024, 2048, 3, 1, 1, 4, 6, 19, None, False, "wgmma"),
    ("wgmma_ragged_n", 96, 200, 3, 1, 1, 1, 3, 76, None, False, "wgmma"),
    ("wgmma_pair_mixed", 32, 256, 3, 1, 1, 1, 12, 38, 64, False, "wgmma"),
    ("below_crossover", 64, 120, 3, 1, 1, 1, 2, 38, None, False, "halo"),
    ("at_crossover", 64, 128, 3, 1, 1, 1, 2, 38, None, False, "wgmma"),
]


def _int8_kernel_inputs(gen, case, dtype, device):
    """(args, kwargs) of int8_conv_nhwc for one case, made with numpy."""
    from octave_tpu_torch.ops import quant

    _, ci, co, k, s, p, g, b, hw, pair_c, transpose, _ = case
    x = _t((gen.standard_normal((b, hw, hw, ci)) * 2).astype(np.float32), device, dtype)
    sx = torch.tensor(float(x.float().abs().max()) / 127 * 0.9, device=device)
    shape = (ci, co, 2, 2) if transpose else (co, ci // g, k, k)
    wq, ws = quant.quantize_weight(_t((gen.standard_normal(shape) * 0.1).astype(np.float32),
                                      device, torch.float32), transpose)
    packed = quant.pack_weight(wq, g, transpose)
    bias = _t(gen.standard_normal(co).astype(np.float32), device, dtype)
    kw = dict(kernel=(k, k), stride=(s, s), padding=(p, p), transpose=transpose)
    if pair_c:
        xb = _t(gen.standard_normal((b, hw, hw, pair_c)).astype(np.float32), device, dtype)
        wqb, wsb = quant.quantize_weight(
            _t((gen.standard_normal((co, pair_c, k, k)) * 0.1).astype(np.float32), device,
               torch.float32))
        kw["pair"] = (xb, quant.pack_weight(wqb), wsb, torch.tensor(0.02, device=device))
        bias = None
    return (x, packed, ws, sx, bias), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", INT8_KERNEL_CASES, ids=lambda c: c[0])
def test_int8_kernel_equals_plain_bit_for_bit(cuda, gen, case, dtype):
    """The kernel's output equals its plain version's (quantise, im2col,
    torch._int_mm, float32 dequantisation) on the card and the CPU's, bit
    for bit: the same true-division quantisation, exact int32 sums, the
    same float32 roundings (no contraction) and one cast; the launch took
    the path its shape selects, and counted it."""
    from octave_tpu_torch.ops.kernels.int8_conv import (
        int8_conv_nhwc,
        int8_conv_nhwc_plain,
        path_counters,
    )

    args, kw = _int8_kernel_inputs(gen, case, dtype, cuda)
    launches = int8_conv_nhwc.launches
    paths = {name: c.launches for name, c in path_counters.items()}
    got = int8_conv_nhwc(*args, **kw)
    torch.cuda.synchronize()
    assert int8_conv_nhwc.launches == launches + 1 and got.dtype == dtype
    assert {name: c.launches - paths[name] for name, c in path_counters.items()} == {
        name: int(name == case[-1]) for name in paths}
    assert torch.equal(got, int8_conv_nhwc_plain(*args, **kw))
    to_cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
    cpu_kw = {**kw, "pair": tuple(map(to_cpu, kw["pair"]))} if "pair" in kw else kw
    assert torch.equal(got.cpu(), int8_conv_nhwc(*map(to_cpu, args), **cpu_kw))


# (C, H, W, residual) beside the served forward's sites: channels that are
# not a power of two or a whole tile, and rows that are not a whole tile
BN_ACT_EXTRA_SITES = [(96, 7, 5, "bn"), (40, 3, 3, "raw"), (2048, 1, 1, "none")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_bn_act_kernel_equals_plain_bit_for_bit(cuda, dtype):
    """At every distinct site of the served model's forward (304², B = 8,
    `chip_smoke.bn_act_sites`) and a few ragged ones, on random inputs, the
    fused batch norm, residual join and ReLU equals the plain chain
    (`addcmul`, `add`, `relu`) bit for bit: it rounds where the chain
    stores, and each affine is one fused multiply-add, as `addcmul`'s is
    on the card (float32 shows it: with the product rounded before the
    add, about a quarter of the affine's float32 results differ). Its
    output is channels-last in x's dtype, written over x when x is `out`,
    and each call is one launch."""
    from chip_smoke import bn_act_inputs, bn_act_sites
    from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act, fused_bn_act_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    sites = list(dict.fromkeys(bn_act_sites(torch))) + BN_ACT_EXTRA_SITES
    launches = fused_bn_act.launches
    for site in sites:
        args = bn_act_inputs(torch, site, 8, dtype, gen)
        got, want = fused_bn_act(*args), fused_bn_act_plain(*args)
        assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want), site
        x = args[0]
        assert fused_bn_act(*args, out=x) is x and torch.equal(x, want), site
    torch.cuda.synchronize()
    assert fused_bn_act.launches == launches + 2 * len(sites)


@pytest.mark.parametrize("res", ["raw", "bn"])
def test_bn_act_consumes_x_even_as_its_own_residual(cuda, res):
    """`ops.norm.bn_act` on CUDA with folded eval norms writes its result
    over x, also where x is the residual too (relu(bn(x) + x) or
    relu(bn(x) + res_bn(x))): the result is the plain chain's on a copy,
    bit for bit, in one launch. With a gradient to record it runs the
    chain and leaves x as it is."""
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.ops.norm import BatchNorm2d, bn_act

    gen = torch.Generator(device=cuda).manual_seed(5)
    c = 64

    def norm():
        m = BatchNorm2d(c).to(cuda, torch.bfloat16).eval()
        with torch.no_grad():
            m.weight.copy_(torch.rand(c, generator=gen, device=cuda) * 1.5 + 0.5)
            m.bias.copy_(torch.rand(c, generator=gen, device=cuda) * 2 - 1)
        m.folded = True
        return m

    bn, res_bn = norm(), (norm() if res == "bn" else None)
    x = (torch.randn(4, c, 19, 21, generator=gen, device=cuda) * 2).to(
        torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        want = bn(x.clone()) + (x.clone() if res_bn is None else res_bn(x.clone()))
    want = torch.relu(want)
    x0 = x.clone()
    chained = bn_act(bn, x, x, res_bn)  # grad enabled, the parameters want one
    assert chained is not x and torch.equal(x, x0) and torch.equal(chained.detach(), want)
    launch_counts(reset=True)
    with torch.inference_mode():
        got = bn_act(bn, x, x, res_bn)
    torch.cuda.synchronize()
    assert got is x and torch.equal(x, want) and launch_counts()["bn_act"] == 1


def test_graphed_int8_predictor_with_bn_act_equals_the_plain_chain(cuda, monkeypatch):
    """The graphed int8 Predictor (bf16, scope decoder, 304², B = 8) on
    the committed weights: its warm-up, capture and replays equal an eager
    twin's whose `bn_act` computes the plain chain in place of the kernel
    (a patch here), bit for bit; each replay launches the fused batch norm
    once per site of the module tree (every BatchNorm2d but the ones
    another pass applies: the encoder's downsample BNs, joined to bn3's,
    and the decoder's, in the epilogue)."""
    import os

    from chip_smoke import phantoms
    from octave_tpu_torch.ops import norm
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act_plain
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.utils.checkpoint import load_weights_npz
    from octave_tpu_torch.utils.convert import from_jax_variables

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sd = from_jax_variables(load_weights_npz(os.path.join(root, "benchmarks", "weights304.npz")))
    calib, images = phantoms(8, 304, seed=31), phantoms(8, 304, seed=11)
    kw = dict(device=cuda, int8_decoder=True, calibration_batches=[calib])
    pred = Predictor(sd, **kw)
    got = [pred(images) for _ in range(3)]  # warm-up, capture, replay
    sites = sum(isinstance(m, norm.BatchNorm2d) for n, m in pred.model.named_modules()
                if not n.endswith(("downsample.1", "downsample.2")))
    launch_counts(reset=True)
    got.append(pred(images))
    torch.cuda.synchronize()
    assert pred.captures == 1 and sites == 82
    assert launch_counts()["bn_act"] == sites
    monkeypatch.setattr(norm, "fused_bn_act",
                        lambda *args, out: out.copy_(fused_bn_act_plain(*args)))
    launch_counts(reset=True)
    want = Predictor(sd, graphed=False, **kw)(images)
    assert launch_counts()["bn_act"] == 0
    for g in got:
        assert np.array_equal(g, want)


def test_int8_kernel_near_rounding_ties(cuda, gen):
    """Activations on and next to half-integer multiples of the scale: the
    kernel's multiply by 1 / sx takes the true division there, so q equals
    round(x / sx) (half to even) as the plain version's does."""
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels.int8_conv import int8_conv_nhwc, int8_conv_nhwc_plain

    for sx in (0.0123456, 0.25, 1.7e-3):
        x = ((gen.integers(-130, 130, (2, 9, 9, 16)) + 0.5) * sx).astype(np.float32)
        x[0, 0, 0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -127.5]) * sx
        x = torch.from_numpy(x).to(cuda)
        wq, ws = quant.quantize_weight(_t((gen.standard_normal((24, 16, 3, 3)) * 0.1)
                                          .astype(np.float32), cuda, torch.float32))
        args = (x, quant.pack_weight(wq), ws, torch.tensor(sx, device=cuda), None, (3, 3),
                (1, 1), (1, 1))
        assert torch.equal(int8_conv_nhwc(*args), int8_conv_nhwc_plain(*args)), sx


def test_int8_kernel_in_a_graph_replay(cuda, gen):
    """Captured in a CUDA graph (a pair and a plain conv on each path), the
    kernel recomputes from the static inputs at every replay and equals the
    plain version on the new values; the capture's launches and their
    paths go to the tally."""
    from octave_tpu_torch.ops.kernels import add_launches, record_launches
    from octave_tpu_torch.ops.kernels.int8_conv import (
        int8_conv_nhwc,
        int8_conv_nhwc_plain,
        path_counters,
    )

    cases = [c for c in INT8_KERNEL_CASES
             if c[0] in ("pair", "groups4", "transpose_wide", "decoder2_conv0")]
    inputs = [_int8_kernel_inputs(gen, c, torch.bfloat16, cuda) for c in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the eager warm-up, as the port's graphs run it
        for args, kw in inputs:
            int8_conv_nhwc(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with record_launches() as tally, torch.cuda.graph(graph):
        outs = [int8_conv_nhwc(*args, **kw) for args, kw in inputs]
    paths = {name: sum(c[-1] == name for c in cases) for name in path_counters}
    assert tally == {int8_conv_nhwc: len(cases),
                     **{path_counters[name]: n for name, n in paths.items() if n}}
    for _ in range(2):
        for args, kw in inputs:
            args[0].copy_(torch.randn_like(args[0].float()).to(args[0].dtype))
            if "pair" in kw:
                kw["pair"][0].copy_(torch.randn_like(kw["pair"][0].float()).to(torch.bfloat16))
        launches = int8_conv_nhwc.launches
        graph.replay()
        add_launches(tally)
        torch.cuda.synchronize()
        assert int8_conv_nhwc.launches == launches + len(cases)
        for out, (args, kw) in zip(outs, inputs):
            assert torch.equal(out, int8_conv_nhwc_plain(*args, **kw))


def test_int8_kernel_on_a_second_card(cuda, gen):
    """On cuda:1 (the mesh Predictor's second replica) the kernel launches
    on that card's current stream and equals the plain version there."""
    from octave_tpu_torch.ops.kernels.int8_conv import int8_conv_nhwc, int8_conv_nhwc_plain

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", 1)
    for case in (INT8_KERNEL_CASES[0], INT8_KERNEL_CASES[9]):
        args, kw = _int8_kernel_inputs(gen, case, torch.bfloat16, dev)
        got = int8_conv_nhwc(*args, **kw)
        torch.cuda.synchronize(dev)
        assert got.device == dev and torch.equal(got, int8_conv_nhwc_plain(*args, **kw))


def test_int8_pair_and_transpose_on_card_equal_cpu(cuda, gen):
    from octave_tpu_torch.ops import quant

    a, b = (_t(gen.standard_normal((2, 16, 19, 19)).astype(np.float32), "cpu", torch.bfloat16)
            for _ in range(2))
    conv = torch.nn.Conv2d(32, 24, 3, padding=1, bias=False).to(torch.bfloat16)
    up = torch.nn.ConvTranspose2d(16, 8, 2, 2).to(torch.bfloat16)
    for prepack in (True, False):
        q = quant.Int8Conv(conv, (0.03, 0.02), prepack)
        want = q((a, b))
        assert torch.equal(q.to(cuda)((a.to(cuda), b.to(cuda))).cpu(), want)
    q = quant.Int8Conv(up, 0.03)
    want = q(a)
    assert torch.equal(q.to(cuda)(a.to(cuda)).cpu(), want)


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_predictor_on_card(cuda, batch):
    """The int8 Predictor (scope decoder: the SplAt fcs at M = B) on the
    committed trained weights at 304², float32 with TF32 off, calibrated on
    other phantoms than the requests: five epilogue launches, 82 of the
    fused batch norm, 25 int8 conv kernel launches (five convs a decoder,
    a pair in one launch) and no
    library int8 GEMM, masks as the card's float32 Predictor's on >= 0.99 of pixels
    (the JAX package's gate) and as the CPU's int8 Predictor's on >= 0.99.
    (At 64², off the resolution the weights were trained at, the CPU's own
    int8 masks agree with its float masks on only ~0.90 of pixels, and a
    float32 rounding anywhere upstream flips int8 roundings downstream.)"""
    import os

    from chip_smoke import phantoms
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.utils.checkpoint import load_weights_npz
    from octave_tpu_torch.utils.convert import from_jax_variables

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sd = from_jax_variables(load_weights_npz(os.path.join(root, "benchmarks", "weights304.npz")))
    calib, images = phantoms(batch, 304, seed=31), phantoms(batch, 304, seed=11)
    kw = dict(dtype=torch.float32)
    int8 = dict(int8_decoder=True, calibration_batches=[calib], **kw)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = Predictor(sd, device=cuda, **int8)
        launch_counts(reset=True)
        quant.int8_mm.launches = 0
        got = card(images)
        torch.cuda.synchronize()
        assert launch_counts() == {"aag": 0, "bn_act": 82, "decoder_epilogue": 5,
                                   "int8_conv": 25}
        assert quant.int8_mm.launches == 0 and len(card.int8_scales) == 33
        plain = Predictor(sd, device=cuda, **kw)(images)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = Predictor(sd, device="cpu", **int8)(images)
    assert got.shape == cpu.shape == (batch, 304, 304, 2) and np.isfinite(got).all()
    for want in (plain, cpu):
        assert float((got.argmax(-1) == want.argmax(-1)).mean()) >= 0.99


# -- the memory and lowering switches on the card ---------------------------------
@pytest.mark.parametrize("mode,aag", [(True, 10), ("conv", 10), ("block:012+conv", 5)])
def test_remat_step_on_card(cuda, mode, aag):
    """One remat step on the card (float32, TF32 off, 64², B = 2) against
    remat=False from the same state and batch: the same losses (the forward
    is the same), gradients within 1e-3 by relative L2 (a wrong recompute
    moves them by O(1); the BNs over few values at 64² amplify the card's
    nondeterministic sums), BN running statistics within 1e-6 of remat=False's
    and `num_batches_tracked` 1 (a second update in the recompute would move
    the statistics by about the momentum), and the AAG kernel launched again
    in the recompute of the modes whose region holds the gates."""
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.train.trainer import build_dataset

    quiet = {"model.instance_noise": "false", "model.label_noise": "false"}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for m in (False, mode):
            tr = _small_trainer(cuda, **{"train.remat": str(m).lower(), **quiet})
            state = tr.init_state()
            batch = tr.device_batch(next(ds.batch_iterator(build_dataset(tr.cfg), 2, seed=0)))
            launch_counts(reset=True)
            losses = tr.train_step(state, batch)
            torch.cuda.synchronize()
            runs[m] = (launch_counts()["aag"], {k: float(v) for k, v in losses.items()},
                       [p.grad.double().cpu() for p in state.segmentor.parameters()],
                       {n: b.double().cpu() for n, b in state.segmentor.named_buffers()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (n0, l0, g0, b0), (n1, l1, g1, b1) = runs[False], runs[mode]
    assert n0 == 5 and n1 == aag
    assert l1 == pytest.approx(l0, rel=1e-6)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g1, g0))
    assert (num / sum(float((b ** 2).sum()) for b in g0)) ** 0.5 < 1e-3
    for name, want in b0.items():
        if name.endswith("num_batches_tracked"):
            assert int(b1[name]) == int(want) == 1, name
        else:
            torch.testing.assert_close(b1[name], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lowering", ["dense", "einsum"])
def test_grouped_conv_lowerings_on_card_equal_cpu(cuda, gen, lowering):
    """The block-diagonal dense and the einsum lowering of a decoder SplAt
    conv (64 -> 128 channels, 3x3, groups 4, bias) give the CPU's output and
    gradients on the card, float32 with TF32 off, within float32 summation
    order (1e-5 of the largest value)."""
    from octave_tpu_torch.models.resnest import lower_grouped_convs_

    x0 = torch.from_numpy(gen.standard_normal((2, 64, 19, 19), dtype=np.float32))
    gy0 = torch.from_numpy(gen.standard_normal((2, 128, 19, 19), dtype=np.float32))
    torch.manual_seed(0)
    base = torch.nn.Conv2d(64, 128, 3, 1, 1, groups=4)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = []
        for dev in ("cpu", cuda):
            conv = torch.nn.Conv2d(64, 128, 3, 1, 1, groups=4)
            conv.load_state_dict(base.state_dict())
            conv = lower_grouped_convs_(torch.nn.Sequential(conv), **{lowering: "all"})[0]
            conv = conv.to(dev).to(memory_format=torch.channels_last)
            x = x0.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_()
            out = conv(x)
            out.backward(gy0.to(dev))
            results.append([t.detach().cpu() for t in (out, x.grad, conv.weight.grad,
                                                       conv.bias.grad)])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# -- float16, the fan-out and the ConvTranspose lowering on the card ------------
DEPTHS = [(304, 304, 32), (152, 152, 64), (76, 76, 256), (38, 38, 512), (19, 19, 1024)]


@pytest.mark.parametrize("hwc", DEPTHS, ids=lambda d: f"C{d[2]}")
def test_kernels_in_float16_at_the_decoder_depths(cuda, gen, hwc):
    """Both kernels take float16 on the card (the Triton sources load in
    float32 and store in the outputs' dtype) and agree with their plain
    versions at the five decoder depths, B = 2, to the float16 rows."""
    h, w_, c = hwc
    f16, f32 = torch.float16, torch.float32
    wk = _t((gen.standard_normal((c, 2)) * 0.1).astype(np.float32), cuda, f32)
    bk = _t((gen.standard_normal(2) * 0.1).astype(np.float32), cuda, f32)
    x = _t(gen.standard_normal((2, h, w_, c)).astype(np.float32), cuda, f16)
    z = _t(gen.standard_normal((2, h, w_, 2 * c)).astype(np.float32), cuda, f16)
    attn = _t(gen.standard_normal((2, 2 * c)).astype(np.float32), cuda, f32)
    rs = _t(gen.uniform(0.5, 2, c).astype(np.float32), cuda, f32)
    rb = _t(gen.uniform(-1, 1, c).astype(np.float32), cuda, f32)
    cases = [("aag", fused_aag, fused_aag_plain, (x, wk, bk)),
             ("decoder_epilogue", fused_decoder_epilogue, fused_decoder_epilogue_plain,
              (z, attn, x, rs, rb, wk, bk))]
    for name, fn, plain, args in cases:
        launches = fn.launches
        out, yhat = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1 and out.dtype == yhat.dtype == f16
        for got, want, tol in zip((out, yhat), plain(*args), kernel_tolerance(name, f16, c)):
            _close(got, want, tol)
    # the train path under autocast: float32 x read in float16, y_hat kept in
    # float32
    out, yhat = fused_aag(x.float(), wk, bk, autocast_dtype=f16)
    assert out.dtype == f16 and yhat.dtype == f32
    ref_out, ref_yhat = fused_aag_plain(x, wk, bk, yhat_dtype=f32)
    _close(out, ref_out, kernel_tolerance("aag", f16, c)[0])
    _close(yhat, ref_yhat, kernel_tolerance("aag", f32, c)[1])


def _aag_autocast_ref(x, w, b, cast):
    """float64 x, w, b: the gate as the train step under autocast computes
    it (logits from x rounded to `cast`, the backward through x itself), and
    the logits, whose `.grad` after a backward is g_z."""
    shift = (x.detach().to(cast).double() - x.detach()) @ w.detach()
    logits = x @ w + b + shift
    logits.retain_grad()
    yhat = torch.softmax(logits, dim=-1)
    return x * yhat[..., 1:].sum(dim=-1, keepdim=True), yhat, logits


@pytest.mark.parametrize("cast", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", [(8, 19, 19, 1024), (8, 76, 76, 256)])
def test_aag_kernel_under_autocast(cuda, gen, shape, cast):
    """The train step's call under bf16 or float16 autocast: float32 x gated
    in `cast` (x*mask in `cast`, y_hat float32), against the plain version
    on x rounded; the float32 backward from x itself against the float64
    formula of the same function, to 1e-4 of each gradient's largest entry
    (g_b, two opposite sums over every pixel that may cancel, of the sum of
    its terms' magnitudes)."""
    c = shape[-1]
    x = _t(gen.standard_normal(shape).astype(np.float32), cuda, torch.float32)
    w, b = (_t((gen.standard_normal(s) * 0.1).astype(np.float32), cuda, torch.float32)
            for s in ((c, 2), (2,)))
    g_out = _t(gen.standard_normal(shape).astype(np.float32), cuda, cast)
    g_yhat = _t(gen.standard_normal(shape[:-1] + (2,)).astype(np.float32), cuda, torch.float32)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    launches = fused_aag.launches
    out, yhat = fused_aag(x, w, b, autocast_dtype=cast)
    torch.cuda.synchronize()
    assert fused_aag.launches == launches + 1
    assert out.dtype == cast and yhat.dtype == torch.float32
    want_out, want_yhat = fused_aag_plain(x.detach().to(cast), w.detach(), b.detach(),
                                          yhat_dtype=torch.float32)
    _close(out, want_out, kernel_tolerance("aag", cast, c)[0])
    _close(yhat, want_yhat, kernel_tolerance("aag", torch.float32, c)[1])
    torch.autograd.backward((out, yhat), (g_out, g_yhat))
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.float32
    ref = [t.detach().double().requires_grad_() for t in (x, w, b)]
    r_out, r_yhat, r_z = _aag_autocast_ref(*ref, cast)
    torch.autograd.backward((r_out, r_yhat), (g_out.double(), g_yhat.double()))
    scales = (ref[0].grad.abs().max(), ref[1].grad.abs().max(),
              r_z.grad.abs().reshape(-1, 2).sum(dim=0).max())
    for got, r, scale in zip((x.grad, w.grad, b.grad), ref, scales):
        torch.testing.assert_close(got.double(), r.grad, rtol=0, atol=1e-4 * float(scale))


def test_fanout_on_one_card_equals_single(cuda, gen):
    """Predictor(mesh=(cuda:0, cuda:0)), two replicas on one card, against
    the single Predictor on the same weights (float32, TF32 off, 64²,
    B = 4): 5 epilogue launches per replica per call, 5 x 2 x k for
    predict_many, and the rows back in order, within float32 summation order
    (cuDNN may pick another algorithm at B = 2 than at B = 4)."""
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import Predictor

    dev0 = torch.device("cuda", 0)
    images = gen.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        single = Predictor.initialize(dtype=torch.float32, device=dev0)
        fanned = Predictor.initialize(dtype=torch.float32, mesh=(dev0, dev0))
        want, want_many = single(images[0]), single.predict_many(images)
        launch_counts(reset=True)
        got = fanned(images[0])
        torch.cuda.synchronize()
        assert launch_counts()["decoder_epilogue"] == 10
        got_many = fanned.predict_many(images)
        torch.cuda.synchronize()
        assert launch_counts()["decoder_epilogue"] == 10 + 20
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == (4, 64, 64, 2) and got_many.shape == (2, 4, 64, 64, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_many, want_many, atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["native", "einsum"])
def test_conv_transpose_lowerings_on_card_equal_cpu(cuda, gen, impl):
    """conv_transpose_2x2 under each lowering on the card against the CPU's
    native one (float32, TF32 off for the conv and the matmul; a
    non-square input, C_in != C_out), and its int8 counterpart: exact int32
    sums, the float32 dequantisation a few ulps apart between the card's and
    the CPU's elementwise kernels (2 ulps at 14 measured), hence 1e-5."""
    from octave_tpu_torch.ops import common, quant

    x = torch.from_numpy(gen.standard_normal((2, 24, 5, 7), dtype=np.float32)).contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(gen.standard_normal((24, 16, 2, 2), dtype=np.float32))
    bias = torch.from_numpy(gen.standard_normal(16, dtype=np.float32))
    want = common.conv_transpose_2x2(x, wt, bias)
    want8 = quant.int8_conv_transpose_2x2(x, wt, bias, 0.03)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        common.set_conv_transpose_impl(impl)
        got = common.conv_transpose_2x2(x.to(cuda), wt.to(cuda), bias.to(cuda))
        got8 = quant.int8_conv_transpose_2x2(x.to(cuda), wt.to(cuda), bias.to(cuda), 0.03)
    finally:
        common.set_conv_transpose_impl("native")
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got8.cpu(), want8, atol=1e-5, rtol=0)


def test_decoder_epilogue_at_the_bench_batch(cuda):
    """The decoder epilogue against its plain version at the bench's B = 256,
    depth 0 (304², C = 32), bf16: z holds 256 * 304^2 * 64 = 1.51e9
    elements, 70% of 2^31, the largest tensor the kernel meets. Inputs are
    drawn on the card (a host draw would take ~12 GB)."""
    b_, h, w_, c, k = 256, 304, 304, 32, 2
    g = torch.Generator(device=cuda).manual_seed(256)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)  # noqa: E731
    z = rn(b_, h, w_, 2 * c).to(torch.bfloat16)
    res = rn(b_, h, w_, c).to(torch.bfloat16)
    attn = rn(b_, 2 * c)
    rs = torch.rand(c, generator=g, device=cuda) * 1.5 + 0.5
    rb = torch.rand(c, generator=g, device=cuda) * 2 - 1
    w = (rn(c, k) * 0.1).contiguous()
    bb = rn(k) * 0.1
    launches = fused_decoder_epilogue.launches
    out, yhat = fused_decoder_epilogue(z, attn, res, rs, rb, w, bb)
    torch.cuda.synchronize()
    assert fused_decoder_epilogue.launches == launches + 1
    ref_out, ref_yhat = fused_decoder_epilogue_plain(z, attn, res, rs, rb, w, bb)
    del z, res
    for got, want, (atol, rtol) in zip((out, yhat), (ref_out, ref_yhat),
                                       kernel_tolerance("decoder_epilogue", torch.bfloat16, c)):
        want = want.float()
        bad = (got.float() - want).abs() > atol + rtol * want.abs()
        assert not bool(bad.any()), f"{int(bad.sum())} elements out of tolerance"


def test_predictor_takes_device_input_in_place(cuda, monkeypatch):
    """A stack already on the card goes through predict_many_device and
    __call__ without an upload (the upload path raises here), single and
    over two replicas of cuda:0, and agrees with the host path (float32 and
    uint8; the host path casts float32 to bf16 on the CPU, the device path on
    the card, both rounding to nearest even)."""
    from octave_tpu_torch.serve import Predictor, _Replica

    dev0 = torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    stack = rng.uniform(0, 1, (2, 4, 64, 64, 3)).astype(np.float32)
    for mesh in (None, (dev0, dev0)):
        pred = Predictor.initialize(device=dev0, mesh=mesh)
        for host in (stack, (stack * 255).astype(np.uint8)):
            want, want_one = pred.predict_many(host), pred(host[0])
            with monkeypatch.context() as m:
                m.setattr(_Replica, "put", lambda self, t: pytest.fail("uploaded"))
                on_card = torch.from_numpy(host).to(dev0)
                got = pred.predict_many(on_card)
                got_one = pred(on_card[0])
            np.testing.assert_allclose(got, want, atol=2**-7, rtol=0)
            np.testing.assert_allclose(got_one, want_one, atol=2**-7, rtol=0)
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


# -- the train step as a CUDA graph ---------------------------------------------
def _graph_trainer(device, graphed, tmp, **extra):
    """64², B = 2, noise on, a schedule that moves every step, float32;
    each call's losses logged to tmp/metrics.jsonl."""
    from octave_tpu_torch.train.trainer import Trainer
    from octave_tpu_torch.utils.config import Config

    cfg = Config().apply_overrides({
        "data.image_size": "[64,64]", "data.synthetic_n": "8", "data.batch_size": "2",
        "model.num_filters": "8", "optim.decay_steps": "6", "train.eval_every": "0",
        "train.log_dir": str(tmp), **extra})
    return Trainer(cfg, device=device, graphed=graphed)


def _logged_losses(tmp):
    return [{k: v for k, v in json.loads(line).items() if k.startswith("train/loss")}
            for line in open(tmp / "metrics.jsonl")]


@pytest.fixture
def deterministic():
    """float32 without TF32, deterministic algorithms where torch has them
    (an op without one warns)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.allow_tf32 = tf32


def _assert_states_equal(got, want):
    from octave_tpu_torch.utils.checkpoint import state_to_dict

    def leaves(obj, path=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, obj

    a, b = dict(leaves(state_to_dict(got))), dict(leaves(state_to_dict(want)))
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert (torch.equal(a[k].cpu(), v.cpu()) if torch.is_tensor(v) else a[k] == v), k


def test_graphed_step_equals_eager_bit_for_bit(cuda, tmp_path, deterministic):
    """Trainer.fit at steps_per_call = 2 for 4 calls, the step captured
    (call 2) and replayed (calls 3, 4) against the eager step: the same
    losses in every call and the same state after, bit for bit (parameters,
    BN statistics, spectral u/v, Adam moments and counts, the schedule, the
    noise generator); 5 AAG launches per step through the replays."""
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.train.steps import GraphedStep

    runs = {}
    for graphed in (False, True):
        tmp = tmp_path / str(graphed)
        tr = _graph_trainer(cuda, graphed, tmp, **{"train.steps_per_call": "2",
                                                   "train.steps": "8", "train.log_every": "2"})
        launch_counts(reset=True)
        state = tr.fit()
        torch.cuda.synchronize()
        runs[graphed] = (state, _logged_losses(tmp), launch_counts()["aag"])
    (eager, le, ne), (graph, lg, ng) = runs[False], runs[True]
    assert eager.graph is None and isinstance(graph.graph, GraphedStep)
    assert graph.graph.graph is not None and graph.graph.calls == 4
    assert len(lg) == 4 and lg == le
    assert ne == ng == 5 * 8
    _assert_states_equal(graph, eager)


def test_registered_generator_draws_fresh_noise_each_replay(cuda):
    """A generator registered with a graph draws anew on each replay, what it
    would draw eagerly, and its state advances as an eager run's does."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    out = torch.empty(5, device=cuda)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        out.copy_(torch.randn(5, device=cuda, generator=gen) + torch.rand((), device=cuda,
                                                                          generator=gen))
    draws = []
    for _ in range(3):
        graph.replay()
        draws.append(out.clone())
    ref = torch.Generator(device=cuda).manual_seed(7)
    want = [torch.randn(5, device=cuda, generator=ref) + torch.rand((), device=cuda, generator=ref)
            for _ in range(3)]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    assert all(torch.equal(a, b) for a, b in zip(draws, want))
    assert torch.equal(gen.get_state(), ref.get_state())


def test_restore_after_capture_drops_the_graph(cuda, tmp_path, deterministic):
    """A restore replaces the optimizers' states, which a captured step
    reads: it drops the graph, and the next fit captures anew. Restored to
    step 2 of a graphed run and trained on to step 4, the state equals that
    run's checkpoint at step 4."""
    from octave_tpu_torch.utils.checkpoint import CheckpointManager, load_state_dict_into

    ckpt = tmp_path / "ckpt"
    tr = _graph_trainer(cuda, None, tmp_path / "log", **{
        "train.steps": "4", "train.log_every": "1", "train.checkpoint_dir": str(ckpt),
        "train.checkpoint_every": "2"})
    state = tr.fit()
    runner = state.graph
    assert runner.graph is not None and CheckpointManager(str(ckpt)).all_steps() == [2, 4]
    step2 = torch.load(ckpt / "step_00000002" / "state.pt", map_location="cpu",
                       weights_only=True)
    load_state_dict_into(state, step2)
    assert state.graph is None and runner.graph is None and state.step == 2
    again = _graph_trainer(cuda, None, tmp_path / "log2", **{"train.steps": "4",
                                                             "train.log_every": "1"})
    state = again.fit(state)
    assert state.step == 4 and state.graph.graph is not None
    want = again.init_state()
    CheckpointManager(str(ckpt)).restore_latest(want)
    _assert_states_equal(state, want)



# -- serving and evaluation as CUDA graphs ----------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "aag"])
def test_graphed_predictor_equals_eager_bit_for_bit(cuda, gen, deterministic, fused):
    """float32 (TF32 off, deterministic algorithms), 64², B = 2: predict_many
    at k = 1, 2, 4 and __call__ graphed against eager, bit for bit, over the
    warm-up, the capture and a replay; 5 kernel launches per forward through
    the replays; one graph per k, __call__ the k = 1 stack's."""
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import Predictor

    kw = dict(image_hw=(64, 64), dtype=torch.float32, use_fused_decoder=fused, device=cuda)
    eager, graphed = Predictor.initialize(graphed=False, **kw), Predictor.initialize(**kw)
    assert graphed.graphed and not eager.graphed and eager.replicas[0].graphs is None
    kernel = "decoder_epilogue" if fused else "aag"
    for k in (1, 2, 4):
        stack = gen.integers(0, 256, (k, 2, 64, 64, 3), dtype=np.uint8)
        want = eager.predict_many(stack)
        for _ in range(3):  # eager warm-up, capture, replay
            launch_counts(reset=True)
            got = graphed.predict_many(stack)
            torch.cuda.synchronize()
            assert launch_counts()[kernel] == 5 * k
            np.testing.assert_array_equal(got, want)
    one = gen.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(graphed(one), eager(one))
    assert graphed.captures == 3


# Predictor configurations beside the default bf16 one (the float32 fused and
# unfused ones are above); einsum_conv_transpose switches the process-wide
# ConvTranspose lowering for its run
PREDICTOR_VARIANTS = {
    "unfolded_bn": {"fold_bn": False},
    "prob_f16": {"output_format": "prob_f16"},
    "mask_u8": {"output_format": "mask_u8"},
    "float16": {"dtype": torch.float16},
    "int8_per_call": {"int8_decoder": True, "int8_prepack": False},
    "int8_dense": {"int8_decoder": True, "int8_scope": "dense"},
    "dense_groups": {"dense_groups": "decoder"},
    "einsum_groups": {"einsum_groups": "decoder+enc"},
    "einsum_conv_transpose": {},
}


@pytest.mark.parametrize("variant", sorted(PREDICTOR_VARIANTS))
def test_every_predictor_variant_captures(cuda, gen, variant):
    """Each Predictor configuration captures on the card (64², B = 2, k = 1
    and 2) and its warm-up, capture and replay equal its eager twin's
    outputs bit for bit: the replay runs the eager call's kernels."""
    from octave_tpu_torch.ops import common
    from octave_tpu_torch.serve import Predictor

    kw = dict(PREDICTOR_VARIANTS[variant], image_hw=(64, 64), device=cuda)
    if kw.get("int8_decoder"):
        kw["calibration_batches"] = [gen.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)]
    common.set_conv_transpose_impl("einsum" if variant == "einsum_conv_transpose" else "native")
    try:
        eager, graphed = Predictor.initialize(graphed=False, **kw), Predictor.initialize(**kw)
        for k in (1, 2):
            stack = gen.integers(0, 256, (k, 2, 64, 64, 3), dtype=np.uint8)
            want = eager.predict_many(stack)
            for _ in range(3):  # eager warm-up, capture, replay
                np.testing.assert_array_equal(graphed.predict_many(stack), want)
        assert graphed.captures == 2
    finally:
        common.set_conv_transpose_impl("native")


def test_graphed_results_are_not_overwritten(cuda, gen, deterministic):
    """Two predict_many_device stacks of other images dispatched back to back
    without a wait, then downloaded in the other order: each equals its own
    eager result, and their device tensors are two copies out of the graph."""
    from octave_tpu_torch.serve import Predictor

    kw = dict(image_hw=(64, 64), dtype=torch.float32, device=cuda)
    eager, graphed = Predictor.initialize(graphed=False, **kw), Predictor.initialize(**kw)
    graphed.warmup(2, (64, 64), ks=(2,))
    assert graphed.captures == 1
    a, b = (gen.integers(0, 256, (2, 2, 64, 64, 3), dtype=np.uint8) for _ in range(2))
    ra, rb = graphed.predict_many_device(a), graphed.predict_many_device(b)
    assert ra.tensor.data_ptr() != rb.tensor.data_ptr()
    got_b, got_a = np.asarray(rb), np.asarray(ra)
    np.testing.assert_array_equal(got_a, eager.predict_many(a))
    np.testing.assert_array_equal(got_b, eager.predict_many(b))
    assert graphed.captures == 1


def test_warmup_result_survives_a_replay(cuda, gen, deterministic):
    """The k = 1 graph captured, then without a wait a stack at a k not seen
    yet (its eager warm-up runs in the pool whose blocks the k = 1 graph
    reuses at every replay) and a k = 1 replay of other images: downloaded
    after both, each equals its own eager result bit for bit."""
    from octave_tpu_torch.serve import Predictor

    kw = dict(image_hw=(64, 64), dtype=torch.float32, device=cuda)
    eager, graphed = Predictor.initialize(graphed=False, **kw), Predictor.initialize(**kw)
    graphed.warmup(2, (64, 64), ks=(1,))
    assert graphed.captures == 1
    for k in (4, 2):  # each unseen: its warm-up follows the k = 1 capture
        stack = gen.integers(0, 256, (k, 2, 64, 64, 3), dtype=np.uint8)
        other = gen.integers(0, 256, (1, 2, 64, 64, 3), dtype=np.uint8)
        fresh, replay = graphed.predict_many_device(stack), graphed.predict_many_device(other)
        got, got_other = np.asarray(fresh), np.asarray(replay)
        np.testing.assert_array_equal(got, eager.predict_many(stack))
        np.testing.assert_array_equal(got_other, eager.predict_many(other))
    assert graphed.captures == 1


def test_batch_server_captures_in_its_worker(cuda, gen, deterministic):
    """Without the warm-up the server's worker meets each k first: it runs
    it eagerly and then captures it while the resolver thread downloads (a
    thread_local capture). Every result equals the eager Predictor's
    (float32), and once every k is captured a flood captures nothing."""
    from octave_tpu_torch.serve import BatchServer, Predictor

    kw = dict(image_hw=(64, 64), dtype=torch.float32, device=cuda)
    eager, graphed = Predictor.initialize(graphed=False, **kw), Predictor.initialize(**kw)
    imgs = [gen.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(64)]
    want = np.concatenate([eager(np.stack(imgs[i:i + 4])) for i in range(0, 64, 4)])
    with BatchServer(graphed, batch=4, image_hw=(64, 64), ks=(1, 2, 4), warmup=False) as srv:
        for _ in range(4):
            np.testing.assert_array_equal(np.stack(list(srv.map(iter(imgs)))), want)
        assert graphed.captures >= 1  # in the worker: k = 4 met more than once
        graphed.warmup(4, (64, 64), ks=(1, 2, 4))
        assert graphed.captures == 3
        np.testing.assert_array_equal(np.stack(list(srv.map(iter(imgs)))), want)
    assert graphed.captures == 3


def test_graphed_stream_replays_without_capturing(cuda, gen):
    """After `warmup`, a graphed int8 predict_stream of 8 dispatches (304²,
    B = 8) captures nothing (the counter `graph.captures` holds) and a
    profile of it holds 8 `octave.graph.replay` spans, one inside each
    dispatch span; the set-up phases read the device's reserved memory."""
    import time
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.utils import profiling

    t = time.time_ns()
    batches = [gen.integers(0, 256, (8, 304, 304, 3), dtype=np.uint8) for _ in range(2)]
    pred = Predictor.initialize(device=cuda, int8_decoder=True,
                                calibration_batches=[batches[0]])
    pred.warmup(8, (304, 304), ks=(1,))
    captures = profiling.counters()["graph.captures"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        outs = list(pred.predict_stream([batches[i % 2] for i in range(8)], depth=2))
    assert len(outs) == 8 and profiling.counters()["graph.captures"] == captures
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("octave.") and str(ev.device_type()).endswith("CPU")]
    assert Counter(n for n, _, _ in spans)["octave.graph.replay"] == 8
    dispatches = [(a, b) for n, a, b in spans if n == "octave.predictor.dispatch"]
    assert len(dispatches) == 8
    for n, a, b in spans:
        if n == "octave.graph.replay":
            assert any(d0 <= a and b <= d1 for d0, d1 in dispatches)
    phases = {p.name: p for p in profiling.phases() if p.start_ns >= t}
    assert {"octave.predictor.build", "octave.quant.calibrate", "octave.quant.quantize",
            "octave.graph.warmup", "octave.graph.capture"} <= set(phases)
    assert phases["octave.predictor.build"].reserved_end > 0


def test_auc_histogram_on_card_equals_cpu(cuda):
    """The fixed-length ROC histogram under deterministic algorithms (no
    warn_only: an op without a deterministic variant raises) and inside a
    CUDA-graph capture equals the CPU's, integer for integer."""
    from octave_tpu_torch.train.steps import StaticGraphs
    from octave_tpu_torch.utils.metrics import AucAccumulator

    rng = np.random.default_rng(3)
    scores = rng.uniform(0, 1, (4, 64, 64)).astype(np.float32)
    scores[0, :8] = np.arange(8)[:, None] / 4096  # bin edges
    scores[1, 0] = 1.0
    target = (rng.uniform(size=scores.shape) > 0.7).astype(np.float32)
    weight = np.array([1, 1, 1, 0], np.float32)
    host = [torch.from_numpy(a) for a in (scores, target, weight)]
    want = torch.cat(list(AucAccumulator.empty(device="cpu").update(*host)))

    def hist(s, t, w):
        return torch.cat(list(AucAccumulator.empty(device=s.device).update(s, t, w)))

    torch.use_deterministic_algorithms(True)
    try:
        dev = [t.to(cuda) for t in host]
        assert torch.equal(hist(*dev).cpu(), want)
        graphs = StaticGraphs(hist, cuda)
        for _ in range(3):  # eager warm-up, capture, replay
            assert torch.equal(graphs(*dev).cpu(), want)
        assert graphs.captures == 1
    finally:
        torch.use_deterministic_algorithms(False)


def test_graphed_evaluate_equals_eager(cuda, tmp_path, deterministic):
    """Trainer.evaluate with the eval step graphed against eager, float32, on
    5 test phantoms in batches of 2 (a ragged last batch of 1, its own
    graph): equal metrics at the warm-up, the captures and the replays;
    after a fit step (the weights updated in place the graphs keep
    reading); after a restore, which drops the graphs."""
    from octave_tpu_torch.utils.checkpoint import CheckpointManager

    extra = {"data.synthetic_n": "5", "train.steps": "1", "train.log_every": "1"}
    eager = _graph_trainer(cuda, False, tmp_path / "e", **extra)
    graphed = _graph_trainer(cuda, None, tmp_path / "g", **extra)
    assert graphed.graphed_eval and not eager.graphed_eval
    state = graphed.init_state()
    for _ in range(3):
        assert graphed.evaluate(state) == eager.evaluate(state)
    graphs = state.eval_graphs
    assert graphs is not None and graphs.captures == 2
    before = graphed.evaluate(state)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(0, state)
    graphed.fit(state)
    assert state.step == 1 and state.eval_graphs is graphs
    after = graphed.evaluate(state)
    assert after == eager.evaluate(state) != before and graphs.captures == 2
    ckpt.restore_latest(state)
    assert state.eval_graphs is None and state.step == 0
    for _ in range(2):
        assert graphed.evaluate(state) == eager.evaluate(state) == before
