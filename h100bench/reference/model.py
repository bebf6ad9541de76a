"""The plain float32 OCTAve networks, written from their published description.

The segmentor is a ResNeSt-50 encoder (radix 2, deep stem of width 32,
avg-down shortcuts, avd pooling) under a U-Net decoder of split-attention
residual blocks, with an adversarial attention gate (1x1 conv to class
logits, softmax, the input scaled by the non-background probability) after
every decoder depth (Chinkamol et al., OCTAve, IEEE TBME 2022; ResNeSt,
arXiv:2004.08955). The critic is the multi-scale LS-GAN discriminator with
spectral-normalised convs, instance noise and label noise.

Both are functions of a flat parameter dict under the reference torch
state-dict names (`encoder_1.0.conv2.fc1.weight`, `spectral_dict.spectral_0.
0.weight_orig`, ...), so one dict of tensors made from a seed feeds this code
and the program alike. Activations are NCHW float32; `Precision` can round
every conv and matmul operand to float8 (e4m3, one scale per tensor), which
is the lower-precision control of the correctness check.

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS_BN = 1e-5
NUM_CLASSES = 2
# decoder depth -> (upsampling in, out, decoder block in, out)
DECODER_WIDTHS = {0: (64, 64, 64, 32), 1: (256, 64, 128, 64), 2: (512, 256, 512, 256),
                  3: (1024, 512, 1024, 512), 4: (2048, 1024, 2048, 1024)}
ENCODER_LAYERS = (3, 4, 6, 3)
Params = Dict[str, torch.Tensor]


class Precision:
    """Where the conv and matmul operands are rounded, for the controls of
    the correctness check: None keeps float32; "fp8" rounds every operand
    to float8 e4m3 with a per-tensor scale (amax / 448), as an fp8 training
    recipe would; "int4_decoder" rounds the decoder blocks' conv inputs to
    int4 with a per-tensor scale and their weights with a scale per output
    channel (amax / 7), the step below the int8 decoder of the serving
    configuration; "int8_decoder" does the same with 255 steps: the serving
    configuration's own decoder, the yardstick of the serving check."""

    mode: Optional[str] = None

    @classmethod
    @contextlib.contextmanager
    def use(cls, mode: Optional[str]):
        old, cls.mode = cls.mode, mode
        try:
            yield
        finally:
            cls.mode = old


def _q(t: torch.Tensor) -> torch.Tensor:
    if Precision.mode != "fp8":
        return t
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t.detach())  # rounded forward, straight-through gradient


def _round_int(t: torch.Tensor, dims, top: int) -> torch.Tensor:
    """Symmetric rounding to 2 x `top` + 1 steps, one scale per slice of
    `dims` (None: the whole tensor)."""
    scale = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / top
    return (t / scale).round().clamp(-top, top) * scale


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
         groups: int = 1) -> torch.Tensor:
    w = p[name + ".weight"]
    if Precision.mode in ("int4_decoder", "int8_decoder") and name.startswith("decoder_"):
        top = 7 if Precision.mode == "int4_decoder" else 127
        x, w = _round_int(x, None, top), _round_int(w, (1, 2, 3), top)
    return F.conv2d(_q(x), _q(w), p.get(name + ".bias"), stride, padding, 1, groups)


def bn(p: Params, name: str, x: torch.Tensor, train: bool,
       stats: Optional[Params] = None) -> torch.Tensor:
    """Batch norm: batch statistics in training, the running ones in eval.
    With `stats` (training only) the batch mean and unbiased variance of
    this layer are stored there under the running-stat names."""
    w, b = p[name + ".weight"], p[name + ".bias"]
    if train:
        if stats is not None:
            c = x.shape[1]
            rm = stats.setdefault(name + ".running_mean", x.new_zeros(c))
            rv = stats.setdefault(name + ".running_var", x.new_ones(c))
            return F.batch_norm(x, rm, rv, w, b, True, 1.0, EPS_BN)
        return F.batch_norm(x, None, None, w, b, True, 0.0, EPS_BN)
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"], w, b, False,
                        0.0, EPS_BN)


class Net:
    """One forward's settings: parameters, train or eval batch norm, and
    where batch statistics go."""

    def __init__(self, p: Params, train: bool, stats: Optional[Params] = None):
        self.p, self.train, self.stats = p, train, stats

    def bn(self, name, x):
        return bn(self.p, name, x, self.train, self.stats)

    def splat(self, name: str, x: torch.Tensor, channels: int, groups: int) -> torch.Tensor:
        """Split-attention 3x3 conv, radix 2, cardinality `groups`."""
        x = F.relu(self.bn(name + ".bn0", conv(self.p, name + ".conv", x, 1, 1, 2 * groups)))
        x0, x1 = x[:, :channels], x[:, channels:]
        gap = (x0 + x1).mean(dim=(2, 3), keepdim=True)
        a = conv(self.p, name + ".fc1", gap, groups=groups)
        a = conv(self.p, name + ".fc2", F.relu(self.bn(name + ".bn1", a)), groups=groups)
        a = torch.softmax(a.view(x.shape[0], 2, channels), dim=1)
        return a[:, 0].view(-1, channels, 1, 1) * x0 + a[:, 1].view(-1, channels, 1, 1) * x1

    def bottleneck(self, name: str, x: torch.Tensor, planes: int, stride: int,
                   downsample: bool) -> torch.Tensor:
        out = F.relu(self.bn(name + ".bn1", conv(self.p, name + ".conv1", x)))
        out = self.splat(name + ".conv2", out, planes, 1)
        if stride > 1:
            out = F.avg_pool2d(out, 3, stride, 1)  # avd, counting the padding
        out = self.bn(name + ".bn3", conv(self.p, name + ".conv3", out))
        residual = x
        if downsample:
            r = F.avg_pool2d(x, stride, stride, ceil_mode=True, count_include_pad=False)
            residual = self.bn(name + ".downsample.2", conv(self.p, name + ".downsample.1", r))
        return F.relu(out + residual)

    def decoder(self, name: str, x: torch.Tensor, out_channels: int) -> torch.Tensor:
        y = F.relu(self.bn(name + ".conv.1", conv(self.p, name + ".conv.0", x, 1, 1)))
        y = F.relu(self.splat(name + ".conv.3", y, out_channels, 2))
        r = self.bn(name + ".downsample.1", conv(self.p, name + ".downsample.0", x))
        return F.relu(y + r)

    def gate(self, name: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x scaled by the non-background probability, the NHWC softmax)."""
        yhat = torch.softmax(conv(self.p, name + ".conv1", x), dim=1)
        return x * yhat[:, 1:].sum(dim=1, keepdim=True), yhat.permute(0, 2, 3, 1)

    def up(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(_q(x), _q(self.p[name + ".up.weight"]),
                                  self.p[name + ".up.bias"], stride=2)

    def segmentor(self, image: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """NHWC image in [0, 1] -> (attention pyramid finest first, NHWC
        class logits)."""
        x = image.permute(0, 3, 1, 2)
        s = "encoder_0_1_2.0"
        x = F.relu(self.bn(s + ".1", conv(self.p, s + ".0", x, 2, 1)))
        x = F.relu(self.bn(s + ".4", conv(self.p, s + ".3", x, 1, 1)))
        x_0_0 = F.relu(self.bn("encoder_0_1_2.1", conv(self.p, s + ".6", x, 1, 1)))
        x = F.max_pool2d(x_0_0, 3, 2, 1)
        taps = []
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), ENCODER_LAYERS)):
            for j in range(blocks):
                stride = (1 if li == 0 else 2) if j == 0 else 1
                x = self.bottleneck(f"encoder_{li + 1}.{j}", x, planes, stride, j == 0)
            if li == 2 and (x.shape[2] % 2 or x.shape[3] % 2):
                taps.append(x)  # x_3, padded below to even
                x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2))
            else:
                taps.append(x)
        x_1, x_2, x_3, x_4 = taps[0], taps[1], taps[2], x
        pyramid = []
        d = self.up("upsampling_4", x_4)[:, :, :x_3.shape[2], :x_3.shape[3]]
        for depth, skip in ((4, x_3), (3, x_2), (2, x_1), (1, x_0_0), (0, None)):
            if depth < 4:
                d = self.up(f"upsampling_{depth}", d)
            inp = d if skip is None else torch.cat([skip, d], dim=1)
            d = self.decoder(f"decoder_{depth}", inp, DECODER_WIDTHS[depth][3])
            d, yhat = self.gate(f"aag_{depth}", d)
            pyramid.append(yhat)
        pyramid.reverse()
        return pyramid, conv(self.p, "fc", d).permute(0, 2, 3, 1)


def segmentor_probabilities(p: Params, image: torch.Tensor) -> torch.Tensor:
    """The served output: softmax of the eval forward's class logits, NHWC."""
    _, logits = Net(p, train=False).segmentor(image)
    return torch.softmax(logits, dim=-1)


def bn_statistics(p: Params, image: torch.Tensor) -> Params:
    """The running mean and (unbiased) variance of every batch norm over a
    spatial map, set to the statistics of `image` in a training-mode
    forward: serving weights whose layers see normalised activations, as
    trained ones do. The split-attention's `bn1`, over per-image global
    averages that barely differ between phantoms, keeps (0, 1): normalised
    by their spread across images it would turn the rounding of an average
    into an O(1) change of the attention."""
    stats: Params = {}
    Net(p, train=True, stats=stats).segmentor(image)
    return {k: v for k, v in stats.items()
            if not any(s in k for s in (".conv2.bn1.", ".conv.3.bn1."))}


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_conv(p: Params, name: str, x: torch.Tensor, update: bool,
                  buffers: Params) -> torch.Tensor:
    """Conv k4 s2 p1 with its weight over its largest singular value, by one
    power iteration from the stored u, v (no gradient through u, v);
    `update` stores the new u, v in `buffers`."""
    w = p[name + ".weight_orig"]
    w_mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = _l2n(w_mat.t() @ buffers[name + ".weight_u"])
        u = _l2n(w_mat @ v)
    if update:
        buffers[name + ".weight_u"], buffers[name + ".weight_v"] = u, v
    sigma = torch.dot(u, w_mat @ v)
    return F.conv2d(_q(x), _q(w / sigma), p[name + ".bias"], 2, 1)


def critic(p: Params, buffers: Params, pyramid: Sequence[torch.Tensor], depth: int,
           generator: torch.Generator, update: bool, noise_dtype: torch.dtype) -> torch.Tensor:
    """(B, 1) critic logits of a finest-first NHWC pyramid. Draws, in order,
    one (H, W) instance-noise map (in `noise_dtype`, as the pyramid's finest
    level is held) and one uniform for the label noise."""
    s = pyramid[0].permute(0, 3, 1, 2)
    noise = torch.randn(s.shape[2:], generator=generator, device=s.device, dtype=noise_dtype)
    s = (s + 0.2 * noise.float()).clamp(0.0, 1.0)
    s = F.leaky_relu(conv(p, "stack_0.1", s, 2, 1), 0.2)
    for i in range(depth):
        s = torch.sigmoid(conv(p, f"squeeze_dict.squeeze_{i}.0", s))
        s = torch.cat((s, pyramid[i + 1].permute(0, 3, 1, 2)), dim=1)
        s = torch.tanh(spectral_conv(p, f"spectral_dict.spectral_{i}.0", s, update, buffers))
    logits = F.linear(_q(s.flatten(1)), _q(p["out.0.weight"].flatten(1)), p["out.0.bias"])
    flip = torch.rand((), generator=generator, device=s.device) < 0.1
    return torch.where(flip, -logits, logits)


# -- parameter shapes ---------------------------------------------------------


def _conv_spec(out: Dict[str, tuple], name: str, cin: int, cout: int, k: int,
               groups: int = 1, bias: bool = False, init: str = "default") -> None:
    out[name + ".weight"] = (init, (cout, cin // groups, k, k))
    if bias:
        out[name + ".bias"] = ("bias", (cout,))


def _bn_spec(out: Dict[str, tuple], name: str, c: int) -> None:
    out[name + ".weight"] = ("bn_weight", (c,))
    out[name + ".bias"] = ("bn_bias", (c,))
    out[name + ".running_mean"] = ("running_mean", (c,))
    out[name + ".running_var"] = ("running_var", (c,))
    out[name + ".num_batches_tracked"] = ("count", ())


def _splat_spec(out, name, cin, channels, groups, bias, init):
    inter = max(cin * 2 // 4, 32)
    _conv_spec(out, name + ".conv", cin, channels * 2, 3, groups * 2, bias, init)
    _bn_spec(out, name + ".bn0", channels * 2)
    _conv_spec(out, name + ".fc1", channels, inter, 1, groups, True, init)
    _bn_spec(out, name + ".bn1", inter)
    _conv_spec(out, name + ".fc2", inter, channels * 2, 1, groups, True, init)


def segmentor_spec() -> Dict[str, tuple]:
    """{state-dict name: (kind, shape)} of the segmentor, in module order."""
    out: Dict[str, tuple] = {}
    s = "encoder_0_1_2.0"
    _conv_spec(out, s + ".0", 3, 32, 3, init="he_out")
    _bn_spec(out, s + ".1", 32)
    _conv_spec(out, s + ".3", 32, 32, 3, init="he_out")
    _bn_spec(out, s + ".4", 32)
    _conv_spec(out, s + ".6", 32, 64, 3, init="he_out")
    _bn_spec(out, "encoder_0_1_2.1", 64)
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), ENCODER_LAYERS)):
        for j in range(blocks):
            name = f"encoder_{li + 1}.{j}"
            cin = inplanes if j == 0 else planes * 4
            _conv_spec(out, name + ".conv1", cin, planes, 1, init="he_out")
            _bn_spec(out, name + ".bn1", planes)
            _splat_spec(out, name + ".conv2", planes, planes, 1, False, "he_out")
            _conv_spec(out, name + ".conv3", planes, planes * 4, 1, init="he_out")
            _bn_spec(out, name + ".bn3", planes * 4)
            if j == 0:
                _conv_spec(out, name + ".downsample.1", cin, planes * 4, 1, init="he_out")
                _bn_spec(out, name + ".downsample.2", planes * 4)
        inplanes = planes * 4
    for depth in range(5):
        ui, uo, di, do = DECODER_WIDTHS[depth]
        out[f"upsampling_{depth}.up.weight"] = ("transpose", (ui, uo, 2, 2))
        out[f"upsampling_{depth}.up.bias"] = ("bias", (uo,))
        name = f"decoder_{depth}"
        _conv_spec(out, name + ".conv.0", di, do, 3)
        _bn_spec(out, name + ".conv.1", do)
        _splat_spec(out, name + ".conv.3", do, do, 2, True, "default")
        _conv_spec(out, name + ".downsample.0", di, do, 1)
        _bn_spec(out, name + ".downsample.1", do)
        _conv_spec(out, f"aag_{depth}.conv1", do, NUM_CLASSES, 1, bias=True)
    _conv_spec(out, "fc", 32, NUM_CLASSES, 1, bias=True)
    return out


def critic_spec(hw: Tuple[int, int], depth: int, nf: int) -> Dict[str, tuple]:
    """{state-dict name: (kind, shape)} of the critic."""
    out: Dict[str, tuple] = {}
    _conv_spec(out, "stack_0.1", NUM_CLASSES, nf, 4, bias=True, init="he_in")
    for i in range(depth):
        _conv_spec(out, f"squeeze_dict.squeeze_{i}.0", nf * 2 ** i, 13, 1, bias=True)
    for i in range(depth):
        name = f"spectral_dict.spectral_{i}.0"
        cin, cout = 13 + NUM_CLASSES, nf * 2 ** (i + 1)
        out[name + ".weight_orig"] = ("default", (cout, cin, 4, 4))
        out[name + ".bias"] = ("bias", (cout,))
        out[name + ".weight_u"] = ("unit", (cout,))
        out[name + ".weight_v"] = ("unit", (cin * 16,))
    h, w = (d // 2 ** (depth + 1) for d in hw)
    out["out.0.weight"] = ("xavier", (1, nf * 2 ** depth, h, w))
    out["out.0.bias"] = ("bias", (1,))
    return out


def make_params(spec: Dict[str, tuple], generator: torch.Generator,
                device: torch.device) -> Params:
    """Seeded float32 tensors for `spec`, drawn on `device` in one call and
    scaled per kind as the program's modules initialise themselves: the
    backbone's convs He-normal by fan-out (`he_out`), the critic's first conv
    by fan-in (`he_in`), its output conv Xavier, every other conv and the
    ConvTransposes at torch's default spread (std 1 / sqrt(3 fan-in));
    biases N(0, 0.02); batch-norm affines near (1, 0), running stats
    (0, 1); power-iteration vectors of unit length."""
    sizes = [math.prod(shape) for _, shape in spec.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out: Params = {}
    offset = 0
    for (name, (kind, shape)), n in zip(spec.items(), sizes):
        t = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "he_out":
            t = t * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "he_in":
            t = t * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "default":
            t = t / math.sqrt(3.0 * math.prod(shape[1:]))
        elif kind == "transpose":
            t = t / math.sqrt(3.0 * math.prod(shape[1:]))
        elif kind == "xavier":
            t = t * math.sqrt(2.0 / (math.prod(shape[1:]) + shape[0] * shape[2] * shape[3]))
        elif kind == "bias":
            t = t * 0.02
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * t
        elif kind == "bn_bias":
            t = 0.1 * t
        elif kind == "running_mean":
            t = torch.zeros_like(t)
        elif kind == "running_var":
            t = torch.ones_like(t)
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        elif kind == "unit":
            t = _l2n(t)
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = t
    return out
