"""Post-training int8 quantisation (PTQ) of the serving path.

The port of `octave_tpu/ops/quant.py`. The JAX package switches its conv
wrappers at trace time; here the model's modules are swapped:

  * calibration: `calibrate(model, batches, forward)` runs eval batches with
    forward pre-hooks that record the running max|x| of every conv's input,
    keyed by the port's module names;
  * scales: `scales_from_stats(stats, include)` keeps the selected keys, as
    {key: absmax / 127};
  * serving: `quantize_(model, scales, prepack=True)` replaces each selected
    `nn.Conv2d`, and the ConvTranspose2d of each selected `Upsampling`, by an
    `Int8Conv`: symmetric per-tensor activation quantisation with the static
    scale, symmetric per-output-channel weights (quantised once here with
    `prepack`, else on every call), an int8 x int8 -> int32 implicit GEMM,
    and the dequantisation and bias in float32, cast back to the input's
    dtype.

Scale keys are module names: `decoder_3.conv.3.conv` (a conv of one input),
`upsampling_2.up`, and `decoder_3.conv.0:a` / `:b` for the skip and
upsampled halves of a decoder's first convs, which take one scale each
(`models/resnest.py::ResNestDecoder`). `utils.convert.scales_from_jax` maps
the JAX package's keys to these. The state dict keeps its keys; prepacked
weights are int8 under them.

Every int8 conv, ConvTranspose and decoder pair runs through one call of
`ops/kernels/int8_conv.py::int8_conv_nhwc` on the NHWC activation: on the
card a hand-written CUDA kernel (quantise as it loads, implicit GEMM on the
int8 tensor cores, dequantise, bias and cast in its epilogue; the JAX
package computes these through XLA, outside any Pallas kernel), on the CPU
its plain version (quantise, im2col, `torch._int_mm`, dequantise). A grouped
conv runs as one block-diagonal GEMM, exact in int32.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.ops.common import nchw, nhwc
from octave_tpu_torch.ops.kernels.int8_conv import int8_conv_nhwc, int8_mm  # noqa: F401

Pair = Tuple[int, int]


class PackedScale(NamedTuple):
    """An offline-quantised conv's scales: the static activation scale and
    the per-output-channel scales of its int8 weight."""

    x_scale: float
    w_scale: torch.Tensor  # (C_out,) float32


def _pair(v) -> Pair:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def quantize_weight(w: torch.Tensor, transpose: bool = False):
    """(wq int8, ws float32 (C_out,)) of a (C_out, C_in/g, kh, kw) conv
    weight, or of a (C_in, C_out, 2, 2) ConvTranspose weight with
    `transpose`: ws = max(absmax over all but C_out, 1e-12) / 127, then
    wq = round(w * (1 / ws)), a reciprocal and a multiply as in the JAX
    package (|w| / ws <= 127)."""
    out_dim = 1 if transpose else 0
    wf = w.float()
    dims = tuple(d for d in range(wf.ndim) if d != out_dim)
    # a true division on every device: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, which may land one rounding off the
    # quotient the CPU and the JAX package take. The divisor is filled on
    # the device, not copied from the host, which a CUDA-graph capture of a
    # per-call int8 conv refuses
    ws = wf.abs().amax(dim=dims).clamp_min(1e-12) / torch.full((), 127.0, dtype=wf.dtype,
                                                             device=wf.device)
    shape = [1] * wf.ndim
    shape[out_dim] = -1
    return torch.round(wf * (1.0 / ws).view(shape)).to(torch.int8), ws


def _x_scale_tensor(x_scale: float, device=None) -> torch.Tensor:
    """The static activation scale as a float32 scalar: max(x_scale, 1e-12)."""
    return torch.tensor(max(float(x_scale), 1e-12), dtype=torch.float32, device=device)


def pack_weight(wq: torch.Tensor, groups: int = 1, transpose: bool = False) -> torch.Tensor:
    """The GEMM operand of an int8 weight: (N, K) row-major, zero-padded to
    multiples of 8. A conv's columns follow the im2col order (kh, kw, C_in),
    a grouped conv's is block-diagonal; a ConvTranspose's rows are
    (kh, kw, C_out) over K = C_in."""
    if transpose:
        packed = wq.permute(2, 3, 1, 0).reshape(-1, wq.shape[0])
    else:
        o, ci, kh, kw = wq.shape
        w = wq.permute(0, 2, 3, 1)  # (O, kh, kw, C_in / g)
        if groups > 1:
            co = o // groups
            dense = wq.new_zeros(o, kh, kw, ci * groups)
            for g in range(groups):
                dense[g * co:(g + 1) * co, :, :, g * ci:(g + 1) * ci] = w[g * co:(g + 1) * co]
            w = dense
        packed = w.reshape(o, -1)
    return F.pad(packed, (0, -packed.shape[1] % 8, 0, -packed.shape[0] % 8)).contiguous()


def _bias(bias: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """The bias as the kernel reads it: x's dtype or float32 (exact)."""
    if bias is None or bias.dtype in (x.dtype, torch.float32):
        return bias
    return bias.float()


def conv_packed(x: torch.Tensor, packed: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor], kernel, stride=1, padding=0, dilation=1,
                pair: Optional[tuple] = None) -> torch.Tensor:
    """The int8 conv of an NCHW `x` with a `pack_weight` operand, one
    `int8_conv_nhwc` call: x quantised by `sx`, the GEMM, y_i32 * (sx * ws)
    + bias in float32, cast to x.dtype. `pair` = (x_b NCHW, packed_b, sx_b,
    ws_b) adds a second input's conv, each dequantised and cast on its own.
    Returns NCHW (a channels_last view)."""
    if pair is not None:
        xb, packed_b, sx_b, ws_b = pair
        pair = (nhwc(xb), packed_b, ws_b, sx_b)
    return nchw(int8_conv_nhwc(nhwc(x), packed, ws, sx, _bias(bias, x), _pair(kernel),
                               _pair(stride), _pair(padding), _pair(dilation), pair=pair))


def conv_transpose_packed(x: torch.Tensor, packed: torch.Tensor, sx: torch.Tensor,
                          ws: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 ConvTranspose2d(2, 2) of an NCHW `x`: one (B*H*W, C_in) x
    (C_in, 4*C_out) GEMM with the 2x2 interleave in its store, dequantised
    per output channel. The values are the same under both
    `ops.common.set_conv_transpose_impl` settings (exact in int32; the
    plain version follows the setting's order as the JAX package's int8
    path does, :190-203). Returns NCHW (a channels_last view)."""
    return nchw(int8_conv_nhwc(nhwc(x), packed, ws, sx, _bias(bias, x), transpose=True))


def _operands(weight: torch.Tensor, x_scale, transpose: bool, groups: int, device):
    """(packed, sx, ws) of a call: an int8 weight takes its scales from a
    PackedScale; a float one is quantised here."""
    if isinstance(x_scale, PackedScale):
        if weight.dtype != torch.int8:
            raise TypeError("a PackedScale goes with an int8 weight")
        wq, ws, x_scale = weight, x_scale.w_scale.to(device), x_scale.x_scale
    else:
        wq, ws = quantize_weight(weight, transpose)
    return pack_weight(wq, groups, transpose), _x_scale_tensor(x_scale, device), ws


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              x_scale, stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """Symmetric int8 conv of an NCHW `x` with a (C_out, C_in/g, kh, kw)
    weight: float, quantised per call, or int8 with `x_scale` a
    PackedScale. Returns x.dtype, NCHW (a channels_last view)."""
    packed, sx, ws = _operands(weight, x_scale, False, groups, x.device)
    return conv_packed(x, packed, sx, ws, bias, tuple(weight.shape[2:]), stride, padding,
                       dilation)


def int8_conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor], x_scale) -> torch.Tensor:
    """int8 ConvTranspose2d(kernel 2, stride 2) of an NCHW `x`; `weight` is
    (C_in, C_out, 2, 2), float or int8 with a PackedScale."""
    packed, sx, ws = _operands(weight, x_scale, True, 1, x.device)
    return conv_transpose_packed(x, packed, sx, ws, bias)


class Int8Conv(nn.Module):
    """The int8 stand-in for an `nn.Conv2d`, or for an `Upsampling`'s
    ConvTranspose2d(2, 2), under the same `weight` / `bias` names.

    `x_scale` is a float, or the (skip, upsampled) pair of a decoder's first
    conv, which then takes the pair `(a, b)` (`takes_pair`): each half is
    multiplied by its slice of the weight's input channels, dequantised and
    cast to the input dtype, and the two are added, all in one
    `int8_conv_nhwc` call (one kernel launch on the card). With
    `prepack` the weight is quantised once here (int8 under `weight`) and
    its GEMM operand packed; a pair's two operands are packed at the first
    call, once the skip's width is known. Without it, every call quantises
    the float weight, as the JAX package's per-call path does: a pair then
    quantises each slice on its own."""

    def __init__(self, conv: nn.Module, x_scale, prepack: bool = True):
        super().__init__()
        self.transpose = isinstance(conv, nn.ConvTranspose2d)
        self.kernel = tuple(conv.kernel_size)
        self.geometry = (conv.stride, conv.padding, conv.dilation)
        self.groups = conv.groups
        self.takes_pair = isinstance(x_scale, tuple)
        self.x_scale = x_scale
        self.prepacked = prepack
        self._halves: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        if not prepack:
            self.weight, self.bias = conv.weight, conv.bias
        else:  # weight and bias stay first in the state dict, both buffers now
            wq, ws = quantize_weight(conv.weight.detach(), self.transpose)
            self.register_buffer("weight", wq)
            self.register_buffer("bias", None if conv.bias is None else conv.bias.detach())
            self.register_buffer("w_scale", ws, persistent=False)
        for i, s in enumerate(x_scale if self.takes_pair else (x_scale,)):
            self.register_buffer(f"sx{i}", _x_scale_tensor(s, conv.weight.device),
                                 persistent=False)
        if prepack and not self.takes_pair:
            self.register_buffer("packed", pack_weight(wq, self.groups, self.transpose),
                                 persistent=False)

    def _run(self, x, packed, sx, ws, bias, pair=None):
        if self.transpose:
            return conv_transpose_packed(x, packed, sx, ws, bias)
        return conv_packed(x, packed, sx, ws, bias, self.kernel, *self.geometry, pair=pair)

    def forward(self, x):
        if not self.takes_pair:
            if not self.prepacked:
                wq, ws = quantize_weight(self.weight, self.transpose)
                return self._run(x, pack_weight(wq, self.groups, self.transpose), self.sx0,
                                 ws, self.bias)
            return self._run(x, self.packed, self.sx0, self.w_scale, self.bias)
        a, b = x
        ca, w = a.shape[1], self.weight
        if not self.prepacked:  # each half quantised on its own
            (wa, wsa), (wb, wsb) = quantize_weight(w[:, :ca]), quantize_weight(w[:, ca:])
            return self._run(a, pack_weight(wa), self.sx0, wsa, None,
                             (b, pack_weight(wb), self.sx1, wsb))
        halves = self._halves.get((ca, w.device))  # the weight may have moved since
        if halves is None:
            halves = (pack_weight(w[:, :ca]), pack_weight(w[:, ca:]))
            self._halves[(ca, w.device)] = halves
        return self._run(a, halves[0], self.sx0, self.w_scale, None,
                         (b, halves[1], self.sx1, self.w_scale))

    def extra_repr(self) -> str:
        return f"x_scale={self.x_scale}, prepacked={self.prepacked}, groups={self.groups}"


def calibrate(model: nn.Module, batches: Iterable, forward: Callable) -> Dict[str, float]:
    """Run `forward(batch)` over the calibration batches and return
    {scale key: max |input|} over all of them, for every input a conv of
    `model` reads: each `nn.Conv2d` the forward calls, under its module
    name, and what a module with `int8_inputs` names (an `Upsampling`'s
    `up`; the `:a` / `:b` halves of a decoder's pair input, whose concat
    the decoder's convs then read records nothing)."""
    stats: Dict[str, torch.Tensor] = {}

    def record(key, x):
        a = x.detach().abs().amax().float()
        stats[key] = a if key not in stats else torch.maximum(stats[key], a)

    def hook(name, m):
        def pre_hook(_m, args):  # returns None: the inputs go on unchanged
            inputs = m.int8_inputs(args[0]) if hasattr(m, "int8_inputs") else {"": args[0]}
            for k, t in inputs.items():
                record(f"{name}.{k}" if k else name, t)
        return pre_hook

    handles = [m.register_forward_pre_hook(hook(name, m)) for name, m in model.named_modules()
               if isinstance(m, nn.Conv2d) or hasattr(m, "int8_inputs")]
    try:
        for batch in batches:
            forward(batch)
    finally:
        for h in handles:
            h.remove()
    return {k: float(v) for k, v in stats.items() if f"{k}:a" not in stats}


def scales_from_stats(stats: Dict[str, float],
                      include: Optional[Callable[[str], bool]] = None) -> Dict[str, float]:
    """{key: absmax / 127} of the recorded keys with absmax > 0 that
    `include` selects (default: the decoder blocks, `decoder_*`)."""
    if include is None:
        include = lambda k: k.startswith("decoder_")  # noqa: E731
    return {k: a / 127.0 for k, a in stats.items() if a > 0.0 and include(k)}


def quantize_(model: nn.Module, scales: Dict[str, float], prepack: bool = True) -> nn.Module:
    """Swap every conv that `scales` names for an `Int8Conv`, in place. A
    pair's conv needs both its `:a` and `:b` scales (with one it stays as
    it is, as in the JAX package)."""
    sites: Dict[str, dict] = {}
    for key, s in scales.items():
        name, _, half = key.partition(":")
        sites.setdefault(name, {})[half or "in"] = s
    for name, sc in sites.items():
        if "in" in sc:
            x_scale = sc["in"]
        elif {"a", "b"} <= sc.keys():
            x_scale = (sc["a"], sc["b"])
        else:
            continue
        parent, _, child = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        setattr(owner, child, Int8Conv(getattr(owner, child), x_scale, prepack))
    return model
