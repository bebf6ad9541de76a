"""The int8 conv of the int8 serving path: a CUDA C++ kernel and its plain version.

Replaces `octave_tpu/ops/quant.py::int8_conv` and `int8_conv_transpose_2x2`
(:118-203), which the JAX package leaves to XLA (no Pallas kernel): quantise
the activation with a static scale, one int8 x int8 -> int32 conv, then
dequantise, add the bias and cast. The kernel (`csrc/int8_conv.cu`, built by
`cuda_build`) does it in one pass as an implicit GEMM, quantising the
activation as it loads it; its note says what bounds it. Inputs:
    x       (B, H, W, C_in) NHWC, float32, bfloat16 or float16
    packed  (N', K') int8, `ops/quant.py::pack_weight`'s GEMM operand
    ws      (N,) float32 per-output-channel weight scales
    sx      float32 scalar tensor, the activation scale
    bias    (N,) float32 or x.dtype, or None
and returns (B, Ho, Wo, N) in x.dtype:
    out = cast(float(sum q(x) * w) * (sx * ws) + bias),
    q(x) = clamp(round(x / sx), -127, 127)   (true division, half to even)
`transpose` computes the 2x2 stride-2 ConvTranspose instead (packed rows
(i, j, o) over K = C_in; out (B, 2H, 2W, C_out)). `pair` = (x_b, packed_b,
ws_b, sx_b) adds a decoder's second input: each sum is dequantised and cast
on its own, then the two are added in x.dtype (no bias).

On a CUDA tensor `int8_conv_nhwc` launches the kernel (and counts the launch
in `int8_conv_nhwc.launches`, and the path the kernel's entry point took, by
the call's shape alone, in the counter `int8_conv.path.<path>`: `wgmma` the
wide halo path, `halo` the halo path, `tap` the per-tap path; see
`csrc/int8_conv.cu`) or raises; on a CPU tensor it runs
`int8_conv_nhwc_plain`, the route the port took before the kernel: quantise,
im2col, `torch._int_mm` (through `int8_mm`), dequantise in float32.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from octave_tpu_torch.ops import common
from octave_tpu_torch.ops.kernels import (
    Counted,
    Counter,
    check_nhwc,
    count_launch,
    register_counter,
)

Pair = Tuple[int, int]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the devices on which the kernels' attributes are set (octave_int8_conv_init)
_READY: set = set()
_READY_LOCK = threading.Lock()
# the kernel's paths, in the entry point's codes, each with its counter
PATHS = ("tap", "halo", "wgmma")
path_counters = {name: Counter(f"int8_conv.path.{name}") for name in PATHS}
_FORCED = threading.local()


@contextlib.contextmanager
def forced_path(path: str):
    """For measurement and the card tests, not a setting: this thread's
    launches inside take `path` (one of PATHS) whatever the shape selects,
    and raise where it does not apply."""
    if path not in PATHS:
        raise ValueError(f"forced_path: {path!r} is not one of {PATHS}")
    before = getattr(_FORCED, "path", None)
    _FORCED.path = path
    try:
        yield
    finally:
        _FORCED.path = before


def quantize_activation(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x / sx), -127, 127) as int8; `sx` is a float32 scalar on
    x's device (a true division, not a multiply by 1 / sx)."""
    return torch.clamp(torch.round(x.float() / sx), -127.0, 127.0).to(torch.int8)


def int8_mm(a: torch.Tensor, b_t: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """(M, K) int8 @ (N', K') int8 -> (M, n) int32, exact. `b_t` is the
    weight operand row-major as (N, K), possibly already zero-padded
    (K' >= K, N' >= n); `a` is padded to K' columns and more than 16 rows
    (CUDA's `_int_mm` wants more than 16 rows and K, N in multiples of 8).
    Counts its calls in `int8_mm.launches`."""
    m, k = a.shape
    n = b_t.shape[0] if n is None else n
    if b_t.shape[1] % 8 or b_t.shape[0] % 8:
        b_t = F.pad(b_t, (0, -b_t.shape[1] % 8, 0, -b_t.shape[0] % 8))
    pad_m = max(17 - m, 0)
    if pad_m or b_t.shape[1] != k:
        a = F.pad(a, (0, b_t.shape[1] - k, 0, pad_m))
    y = torch._int_mm(a, b_t.t())
    count_launch(int8_mm)
    return y[:m, :n] if pad_m or b_t.shape[0] != n else y


int8_mm = Counted("int8_mm", int8_mm)  # not in launch_counts(): the plain route


def _pair(v) -> Pair:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def out_size(h: int, w: int, kernel: Pair, stride: Pair, padding: Pair,
             dilation: Pair) -> Pair:
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1


def _im2col(xq: torch.Tensor, kernel: Pair, stride: Pair, padding: Pair,
            dilation: Pair) -> Tuple[torch.Tensor, int, int]:
    """(B, H, W, C) int8 -> ((B*Ho*Wo, kh*kw*C) columns in (kh, kw, C)
    order, Ho, Wo)."""
    b, h, w, c = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = out_size(h, w, kernel, stride, padding, dilation)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return xq.reshape(b * h * w, c), h, w
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    taps = [xp[:, i * dh: i * dh + sh * (ho - 1) + 1: sh, j * dw: j * dw + sw * (wo - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c), ho, wo


def _plain_one(x, packed, ws, sx, bias, kernel, stride, padding, dilation, transpose):
    b, h, w, _ = x.shape
    n = ws.shape[0]
    xq = quantize_activation(x, sx)
    if transpose:
        # 'native' interleaves the int32 sums into the strided output first,
        # as XLA's conv_transpose writes it, then dequantises; 'einsum'
        # dequantises the GEMM's 2x2 blocks and interleaves last (the JAX
        # package's int8 path, :190-203). Exact in int32: the same values.
        y = int8_mm(xq.reshape(b * h * w, -1), packed, 4 * n).reshape(b, h, w, 2, 2, n)
        native = common.conv_transpose_impl() == "native"
        if native:
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, n)
    else:
        cols, ho, wo = _im2col(xq, kernel, stride, padding, dilation)
        y = int8_mm(cols, packed, n).reshape(b, ho, wo, n)
    y = y.float() * (sx * ws)
    if bias is not None:
        y = y + bias.float()
    y = y.to(x.dtype)
    if transpose and not native:
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, n)
    return y


def int8_conv_nhwc_plain(x, packed, ws, sx, bias=None, kernel=(1, 1), stride=(1, 1),
                         padding=(0, 0), dilation=(1, 1), transpose=False, pair=None):
    """The kernel's function in PyTorch (see the module docstring): each
    source quantised, im2col'd, multiplied by `int8_mm` and dequantised in
    float32; a pair's two results, each cast to x.dtype, added."""
    geometry = (kernel, stride, padding, dilation, transpose)
    y = _plain_one(x, packed, ws, sx, bias, *geometry)
    if pair is not None:
        y = y + _plain_one(*pair, None, *geometry)
    return y


def _check_operand(name, packed, ws, sx, k, n, dev):
    if packed.dtype != torch.int8 or packed.ndim != 2 or not packed.is_contiguous():
        raise ValueError(f"{name}: the packed weight must be a contiguous 2-D int8 tensor; "
                         f"got {packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] < n or packed.shape[1] < k or packed.shape[1] % 8:
        raise ValueError(f"{name}: packed weight {tuple(packed.shape)} does not cover N={n}, "
                         f"K={k} in rows of a multiple of 8 bytes")
    if ws.dtype != torch.float32 or ws.ndim != 1 or not ws.is_contiguous():
        raise ValueError(f"{name}: weight scales must be contiguous 1-D float32")
    if sx.dtype != torch.float32 or sx.numel() != 1:
        raise ValueError(f"{name}: the activation scale must be one float32 value")
    if any(t.device != dev for t in (packed, ws, sx)):
        raise ValueError(f"{name}: operands must be on {dev}")


def int8_conv_nhwc(x: torch.Tensor, packed: torch.Tensor, ws: torch.Tensor,
                   sx: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   kernel: Pair = (1, 1), stride: Pair = (1, 1), padding: Pair = (0, 0),
                   dilation: Pair = (1, 1), transpose: bool = False,
                   pair: Optional[tuple] = None) -> torch.Tensor:
    """See the module docstring. Checks every argument before any launch
    and raises on what the kernel does not take."""
    kernel, stride, padding, dilation = map(_pair, (kernel, stride, padding, dilation))
    dev = x.device
    check_nhwc("x", x, 4, dev)
    b, h, w, c = x.shape
    cout = ws.shape[0] if ws.ndim == 1 else -1
    if transpose:
        kernel, stride, padding, dilation = (1, 1), (1, 1), (0, 0), (1, 1)
    ho = wo = 0
    if min(kernel + stride + dilation) >= 1 and min(padding) >= 0:
        ho, wo = out_size(h, w, kernel, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv: no output for input {tuple(x.shape)}, kernel {kernel}, "
                         f"stride {stride}, padding {padding}, dilation {dilation}")
    n = 4 * cout if transpose else cout
    k = kernel[0] * kernel[1] * c
    _check_operand("x", packed, ws, sx, k, n, dev)
    if bias is not None and (bias.shape != (cout,) or bias.device != dev
                             or bias.dtype not in (torch.float32, x.dtype)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({cout},) tensor of float32 or "
                         f"{x.dtype} on {dev}")
    if pair is not None:
        xb, packed_b, ws_b, sx_b = pair
        check_nhwc("pair x", xb, 4, dev)
        if xb.shape[:3] != x.shape[:3] or xb.dtype != x.dtype:
            raise ValueError(f"pair: x_b {tuple(xb.shape)} {xb.dtype} against x "
                             f"{tuple(x.shape)} {x.dtype}")
        if transpose or bias is not None:
            raise ValueError("pair: only a conv without a bias takes a pair")
        if ws_b.shape != ws.shape:
            raise ValueError("pair: both halves have one weight scale per output channel")
        _check_operand("pair", packed_b, ws_b, sx_b, kernel[0] * kernel[1] * xb.shape[3], n, dev)
    if dev.type == "cuda":
        return _launch(x, packed, ws, sx, bias, kernel, stride, padding, dilation, transpose,
                       pair, (b, h, w, ho, wo, n, cout))
    if dev.type == "cpu":
        return int8_conv_nhwc_plain(x, packed, ws, sx, bias, kernel, stride, padding, dilation,
                                    transpose, pair)
    raise ValueError(f"int8_conv_nhwc: no implementation for device {dev}")


def _ready(lib, device: torch.device) -> None:
    """Set the kernels' attributes (their dynamic shared memory) on `device`
    the first time it launches one: at load time, never inside a CUDA-graph
    capture (a Predictor's first call at a shape runs eagerly)."""
    with _READY_LOCK:
        if device.index in _READY:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"int8_conv: first launch on {device} inside a CUDA-graph "
                               "capture; run one eager call on the device first")
        err = lib.octave_int8_conv_init()
        if err:
            raise RuntimeError(f"int8_conv: setting the kernels' attributes on {device} "
                               f"failed: {lib.octave_cuda_error(err).decode()}")
        _READY.add(device.index)


def _launch(x, packed, ws, sx, bias, kernel, stride, padding, dilation, transpose, pair, dims):
    from octave_tpu_torch.ops.kernels import cuda_build

    b, h, w, ho, wo, n, cout = dims
    shape = (b, 2 * h, 2 * w, cout) if transpose else (b, ho, wo, n)
    sources = [(x, packed, ws, sx)] + ([pair] if pair is not None else [])
    for xs, ps, _, _ in sources:
        if ps.data_ptr() % 8:
            raise ValueError("int8 conv: the packed weight must start on an 8-byte boundary")
    vec = all(xs.shape[3] % 8 == 0 and xs.data_ptr() % 16 == 0 for xs, *_ in sources)
    src = []
    for xs, ps, wss, sxs in sources + sources[:1] * (2 - len(sources)):
        c = xs.shape[3]
        src += [xs.data_ptr(), ps.data_ptr(), wss.data_ptr(), sxs.data_ptr(), c,
                kernel[0] * kernel[1] * c, ps.shape[1], ps.shape[0]]
    with torch.cuda.device(x.device):
        lib = cuda_build.load()
        _ready(lib, x.device)
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(x.device).cuda_stream
        forced = getattr(_FORCED, "path", None)
        taken = ctypes.c_int(-1)
        err = lib.octave_int8_conv(
            *src, len(sources), None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == torch.float32), out.data_ptr(),
            _DTYPE_CODE[x.dtype], int(vec), b, h, w, ho, wo, *kernel, *stride, *padding,
            *dilation, n, cout, int(transpose), int(n % 2 == 0 and cout % 2 == 0), stream,
            -1 if forced is None else PATHS.index(forced), ctypes.byref(taken))
    if err:
        raise RuntimeError(f"int8_conv: launch failed: {lib.octave_cuda_error(err).decode()}")
    if not 0 <= taken.value < len(PATHS):
        raise RuntimeError(f"int8_conv: the kernel reported no path ({taken.value})")
    count_launch(int8_conv_nhwc)
    count_launch(path_counters[PATHS[taken.value]])
    return out


int8_conv_nhwc = register_counter("int8_conv", int8_conv_nhwc)
