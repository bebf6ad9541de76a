"""ResNeSt-50 split-attention backbone and U-Net decoder blocks, in PyTorch.

The port of `octave_tpu/models/resnest.py`. Parameters are NCHW and named as
in the reference torch state dict (`conv`, `bn0`, `fc1`, ..., `downsample.1`),
so a reference state dict loads with `load_state_dict`; activations run
channels_last. Counterparts:
  * SplAtConv2d     octave_tpu/models/resnest.py:361-451
  * Bottleneck      :478-566
  * BasicBlock      :454-476
  * ResNeStConfig   :570-588
  * ResNeSt         :589-741, resnest50 :744-758
  * ResNestDecoder  :761-855
  * Upsampling      :858-884
  * BuildResNet     :887-912
  * the grouped-conv lowerings (`groups_as_dense`, `groups_as_einsum`,
    `grouped_conv_einsum`, `dense_groups_include`, :62-330) as modules that
    `lower_grouped_convs_` swaps in, and the block remat of the Bottlenecks
    and decoder blocks (:599-640; octave_tpu/models/segmentor.py:111-127)
    as their `remat` attribute (`ops/remat.py`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.ops import remat
from octave_tpu_torch.ops.common import (  # noqa: F401  (nchw: re-exported)
    avg_pool2d,
    conv_transpose_2x2,
    max_pool2d,
    nchw,
    nhwc,
)
from octave_tpu_torch.ops.kernels.decoder_epilogue import fused_decoder_epilogue
from octave_tpu_torch.ops.norm import BatchNorm2d, bn_act


class SplAtConv2d(nn.Module):
    """Split-attention 3x3 conv, radix 2: grouped conv to 2C channels, BN,
    ReLU; the two radix splits are summed, pooled, and passed through fc1,
    BN, ReLU, fc2 to per-channel logits; a softmax over the radix weights
    the splits. `groups` is the cardinality."""

    def __init__(self, in_channels: int, channels: int, groups: int = 1, bias: bool = True):
        super().__init__()
        inter_channels = max(in_channels * 2 // 4, 32)  # reduction factor 4
        self.channels = channels
        self.conv = nn.Conv2d(in_channels, channels * 2, 3, 1, 1, groups=groups * 2, bias=bias)
        self.bn0 = BatchNorm2d(channels * 2)
        self.fc1 = nn.Conv2d(channels, inter_channels, 1, groups=groups)
        self.bn1 = BatchNorm2d(inter_channels)
        self.fc2 = nn.Conv2d(inter_channels, channels * 2, 1, groups=groups)

    def forward(self, x: torch.Tensor, return_parts: bool = False):
        """With return_parts=True, stop before the radix apply and return
        (z, attn_logits): z (B, 2C, H, W) after BN0 + ReLU and the fc2 logits
        (B, 2C) laid out [radix-0 channels, radix-1 channels], which the
        fused decoder epilogue consumes."""
        c = self.channels
        x = bn_act(self.bn0, self.conv(x))
        b = x.shape[0]
        x0, x1 = x[:, :c], x[:, c:]
        gap = (x0 + x1).mean(dim=(2, 3), keepdim=True)
        atten = self.fc2(bn_act(self.bn1, self.fc1(gap))).view(b, 2 * c)
        if return_parts:
            return x, atten
        attn = torch.softmax(atten.view(b, 2, c), dim=1)
        return attn[:, 0].view(b, c, 1, 1) * x0 + attn[:, 1].view(b, c, 1, 1) * x1


class Bottleneck(nn.Module):
    """ResNeSt-50 bottleneck: 1x1, split-attention 3x3 followed, when
    strided, by the avd AvgPool2d(3, stride, 1), then 1x1 to 4x planes; the
    shortcut of a stage's first block is avg_down: AvgPool2d(stride, stride,
    ceil_mode, not counting padding), 1x1 conv, BN. `remat` (False, True or
    "conv", see `ops.remat.run`) makes the block one recomputed region in
    training."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.remat = False
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = SplAtConv2d(planes, planes, groups=1, bias=False)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample: Optional[nn.Sequential] = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride, ceil_mode=True, count_include_pad=False),
                nn.Conv2d(inplanes, planes * 4, 1, bias=False),
                BatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(self.remat if self.training else False, self._block, x)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(bn_act(self.bn1, self.conv1(x)))
        if self.stride > 1:
            out = avg_pool2d(out, 3, self.stride, 1)
        out = self.conv3(out)
        if self.downsample is None:
            return bn_act(self.bn3, out, x)
        pool, conv, bn = self.downsample  # its BN joins bn3's pass
        return bn_act(self.bn3, out, conv(pool(x)), bn)


@dataclasses.dataclass(frozen=True)
class ResNeStConfig:
    """The ResNet constructor's arguments (the JAX package's ResNeStConfig,
    octave_tpu/models/resnest.py:570-588). The port builds resnest50's
    block: `layers`, `stem_width` and `num_classes` (the classifier the
    segmentor does not use) may vary; the other fields must keep these
    values."""

    layers: Tuple[int, ...] = (3, 4, 6, 3)
    radix: int = 2
    groups: int = 1
    bottleneck_width: int = 64
    num_classes: int = 1000
    deep_stem: bool = True
    stem_width: int = 32
    avg_down: bool = True
    avd: bool = True
    avd_first: bool = False
    final_drop: float = 0.0
    dilated: bool = False
    dilation: int = 1


_FIXED = {f.name: f.default for f in dataclasses.fields(ResNeStConfig)
          if f.name not in ("layers", "stem_width", "num_classes")}


class ResNeSt(nn.Module):
    """ResNeSt backbone with the deep stem (three 3x3 convs of width
    stem_width, stem_width, 2 stem_width, then BN and ReLU as `bn1`/`relu`),
    the stem's MaxPool2d(3, 2, 1), and four stages `layer1..4` of
    Bottlenecks. The segmentor taps the stages; `forward` returns the last
    one.

    Block remat, as the JAX ResNeSt's fields: with `remat_blocks` true each
    Bottleneck of the encoder layers `remat_layers` names (1-based; True:
    all) is its own recomputed region, which with `remat_save_convs` keeps
    its conv outputs. Parameters and state dict are the same either way.

    Every conv weight, once the stages are built, is drawn anew by
    `resnet_conv_init_`, as the reference and the JAX package draw them."""

    def __init__(self, config: ResNeStConfig = ResNeStConfig(), remat_blocks=False,
                 remat_save_convs: bool = False, remat_layers=True):
        super().__init__()
        other = {k: getattr(config, k) for k, v in _FIXED.items() if getattr(config, k) != v}
        if other:
            raise NotImplementedError(f"the port builds resnest50's blocks only; {other} differ")
        stem_width = config.stem_width
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, stem_width, 3, 2, 1, bias=False), BatchNorm2d(stem_width),
            nn.ReLU(inplace=True),
            nn.Conv2d(stem_width, stem_width, 3, 1, 1, bias=False), BatchNorm2d(stem_width),
            nn.ReLU(inplace=True),
            nn.Conv2d(stem_width, stem_width * 2, 3, 1, 1, bias=False),
        )
        self.bn1 = BatchNorm2d(stem_width * 2)
        self.relu = nn.ReLU(inplace=True)
        inplanes = stem_width * 2
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), config.layers)):
            stride = 1 if li == 0 else 2
            stage = [Bottleneck(inplanes, planes, stride, has_downsample=True)]
            stage += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
            if remat_blocks and (remat_layers is True or li + 1 in remat_layers):
                for block in stage:
                    block.remat = "conv" if remat_save_convs else True
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
            inplanes = planes * 4
        resnet_conv_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW image -> layer4 features (B, 2048, H/32, W/32)."""
        x = max_pool2d(stem(self.conv1, self.bn1, x), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def stem(conv1: nn.Sequential, bn1: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """The deep stem: conv1's three convs, the first two each with its BN
    and ReLU, then bn1 and the ReLU after it (`ResNeSt.relu`). Each BN and
    the ReLU after it are one `bn_act`, which stands for the skipped
    `nn.ReLU(inplace=True)` modules."""
    conv_a, bn_a, _, conv_b, bn_b, _, conv_c = conv1
    x = bn_act(bn_a, conv_a(x), relu_inplace=True)
    x = bn_act(bn_b, conv_b(x), relu_inplace=True)
    return bn_act(bn1, conv_c(x), relu_inplace=True)


def resnet_conv_init_(module: nn.Module) -> None:
    """Draw the weight of every nn.Conv2d under `module`, in module order,
    from N(0, sqrt(2/n)) with n = kh*kw*out_channels, from torch's global
    RNG; biases keep their draws. The reference ResNet's re-init loop
    (quoted at octave_tpu/models/resnest.py:383-386) and the JAX package's
    `resnet_conv_init` (octave_tpu/ops/common.py:63), which its ResNeSt
    (:636) and Bottleneck (:507) give every backbone conv, the
    split-attention conv, fc1 and fc2 included."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.normal_(0.0, math.sqrt(2.0 / n))


def resnest50(**remat_kw) -> ResNeSt:
    """The resnest50 configuration: layers (3, 4, 6, 3), radix 2,
    cardinality 1, bottleneck width 64, deep stem of width 32, avd and
    avg_down; `remat_kw` as ResNeSt takes them."""
    return ResNeSt(ResNeStConfig(), **remat_kw)


class BasicBlock(nn.Module):
    """CE-Net's basic residual block (the reference's resnest.py:142-167):
    3x3 conv (strided), BN, ReLU, 3x3 conv, BN, plus the shortcut (a strided
    1x1 conv and BN when `has_downsample`), joined by ReLU(sum)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample: Optional[nn.Sequential] = None
        if has_downsample:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class BuildResNet(nn.Module):
    """CE-Net's ResNet factory (the reference's resnest.py:462-511): a 7x7
    stride-2 conv, BN, ReLU, MaxPool2d(3, 2, 1) and four stages
    `layer1..4` of BasicBlocks of widths 64, 128, 256, 512; `forward` takes
    NCHW and returns the layer4 map."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage = []
            for bi in range(blocks):
                s = (1 if li == 0 else 2) if bi == 0 else 1
                stage.append(BasicBlock(inplanes, planes, s,
                                        has_downsample=bi == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class ResNestDecoder(nn.Module):
    """U-Net decoder residual block: [3x3 conv, BN, ReLU, SplAtConv2d(groups=2,
    radix=2), ReLU] plus a 1x1 conv + BN shortcut, joined by ReLU(sum).
    `remat` (False, True or "conv", see `ops.remat.run`) makes the training
    block, the skip concat included, one recomputed region."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.remat = False
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
            SplAtConv2d(out_channels, out_channels, groups=2, bias=True),
            nn.ReLU(inplace=True),
        )
        self.downsample = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, bias=False), BatchNorm2d(out_channels))

    def int8_inputs(self, x) -> dict:
        """Calibration (ops/quant.py): the skip and upsampled halves of a
        pair input, under the scale keys of the two convs that read them."""
        if not isinstance(x, tuple):
            return {}
        return {f"{conv}:{half}": t for conv in ("conv.0", "downsample.0")
                for half, t in zip("ab", x)}

    def _inputs(self, x):
        """(input of conv.0, input of downsample.0). A (skip, up) pair goes
        as it is to an int8 conv that takes pairs, and as the concat to any
        other."""
        if not isinstance(x, tuple):
            return x, x
        pair = [getattr(s[0], "takes_pair", False) for s in (self.conv, self.downsample)]
        cat = None if all(pair) else torch.cat(x, dim=1)
        return tuple(x if p else cat for p in pair)

    def _block(self, *parts: torch.Tensor) -> torch.Tensor:
        xc, xd = self._inputs(parts if len(parts) > 1 else parts[0])
        conv, bn, _, splat, relu = self.conv  # conv.2's ReLU is conv.1's `bn_act`
        y = relu(splat(bn_act(bn, conv(xc), relu_inplace=True)))
        return F.relu(y + self.downsample(xd))

    def forward(self, x, gate: Optional[nn.Conv2d] = None):
        """x: (B, in, H, W), the concat of skip and upsampled maps, or the
        (skip, up) pair.

        With `gate` (the following attention gate's 1x1 conv) in eval mode,
        the block's tail — radix apply, inner ReLU, shortcut BN, residual,
        outer ReLU and the gate itself — runs as one fused epilogue and the
        call returns (gated (B,C,H,W), y_hat (B,H,W,K)) instead of the block
        output."""
        if gate is None or self.training:
            parts = x if isinstance(x, tuple) else (x,)
            return remat.run(self.remat if self.training else False, self._block, *parts)
        xc, xd = self._inputs(x)
        conv, bn, _, splat, _ = self.conv
        z, attn = splat(bn_act(bn, conv(xc)), return_parts=True)
        res_conv, res_bn = self.downsample
        rs, rb = res_bn.eval_affine()
        k = gate.out_channels
        out, yhat = fused_decoder_epilogue(
            nhwc(z), attn, nhwc(res_conv(xd)), rs, rb,
            gate.weight.view(k, -1).t(), gate.bias)
        return nchw(out), yhat


class Upsampling(nn.Module):
    """ConvTranspose2d(kernel_size=2, stride=2), named `up` as in the reference."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_channels, out_channels, 2, 2)

    def int8_inputs(self, x) -> dict:
        """Calibration (ops/quant.py): the input of `up`, which forward does
        not call while it is a ConvTranspose2d."""
        return {"up": x}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.up, nn.ConvTranspose2d):
            return conv_transpose_2x2(x, self.up.weight, self.up.bias)
        return self.up(x)  # its int8 stand-in


# -- the grouped-conv lowerings ---------------------------------------------
# The backbone's Bottleneck blocks, the scope 'enc' selects (the JAX package's
# `layer{N}_{i}` blocks)
_ENCODER_BLOCK = re.compile(r"encoder_[1-4]\.")


def dense_groups_include(spec: str) -> Optional[Callable[[str], bool]]:
    """A `dense_groups` / `einsum_groups` spec -> a predicate over the port's
    module names, or None for every grouped conv: the port's copy of
    octave_tpu/models/resnest.py::dense_groups_include (:187-224), with its
    grammar and errors.

    'all'              every grouped conv
    'decoder'          every decoder block's (`decoder_*`, the dual
                       decoders' `decoder_{1,0}_c` included, as in JAX)
    'decoder:<digits>' the named decoder depths' (`decoder:1` names
                       `decoder_1` and `decoder_1_c`, as JAX's prefix does)
    'enc'              the backbone Bottlenecks' (`encoder_1..4`)
    and '+'-joined combinations of the last three."""
    if spec == "all":
        return None
    preds = []
    for part in spec.split("+"):
        if part == "decoder":
            preds.append(lambda n: n.startswith("decoder_"))
        elif part.startswith("decoder:"):
            digits = part.split(":", 1)[1]
            if not digits or not digits.isdigit():
                raise ValueError(
                    f"bad dense_groups stage list {spec!r}; expected e.g. 'decoder:01'")
            names = tuple(f"decoder_{d}" for d in digits)
            preds.append(lambda n, names=names: n.startswith(names))
        elif part == "enc":
            preds.append(lambda n: _ENCODER_BLOCK.match(n) is not None)
        else:
            raise ValueError(
                f"unknown dense_groups {spec!r}; expected None | 'decoder' | "
                "'decoder:<digits>' | 'enc' | 'all' or '+'-joined combinations")
    if len(preds) == 1:
        return preds[0]
    return lambda n: any(f(n) for f in preds)


def block_diagonal(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped conv's (g*co, ci, kh, kw) weight as the (g*co, g*ci, kh, kw)
    weight of the dense conv that computes the same: group i's block on the
    diagonal, zeros elsewhere. Its gradient drops the off-block entries."""
    feat, ci = weight.shape[:2]
    co = feat // groups
    dense = weight.new_zeros(feat, ci * groups, *weight.shape[2:])
    for gi in range(groups):
        dense[gi * co:(gi + 1) * co, gi * ci:(gi + 1) * ci] = weight[gi * co:(gi + 1) * co]
    return dense


def grouped_conv_einsum(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        groups: int, stride=(1, 1), padding=(0, 0),
                        dilation=(1, 1)) -> torch.Tensor:
    """A grouped conv of an NCHW x as kh*kw shifted batched matmuls, the JAX
    package's `grouped_conv_einsum` (:147-184): each kernel tap (iy, ix)
    contributes einsum('bhwgi,goi->bhwgo') over the shifted NHWC input, the
    taps summed in row-major order, then the bias. `weight` is the grouped
    (g*co, ci, kh, kw) layout nn.Conv2d holds. Returns NCHW with
    channels_last memory, in the dtype the conv would return (autocast's
    under autocast, else x's).

    The matmuls and their sum run in float32 (float64 for float64) and the
    result is rounded once, as cuDNN's bf16 conv accumulates: in bf16, taps
    rounded one by one put a 304² B = 32 serving mask's argmax 0.0012 of
    pixels from the grouped conv's (`chip_smoke.py` phase 10), where the
    JAX package's bf16 einsum rounds each tap. The output is the `conv_out`
    tensor the save-the-convs remat policy keeps (`ops/remat.py`)."""
    b, cin, _, _ = x.shape
    feat, ci, kh, kw = weight.shape
    g = groups
    co = feat // g
    if cin != ci * g:
        raise ValueError(f"input has {cin} channels; the weight wants {ci} x {g} groups")
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    acc = torch.promote_types(dtype, torch.float32)
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    with torch.autocast(dev, enabled=False):
        xh = x.permute(0, 2, 3, 1).to(acc)
        if ph or pw:
            xh = F.pad(xh, (0, 0, pw, pw, ph, ph))
        hp, wp = xh.shape[1:3]
        ho = (hp - (kh - 1) * dh - 1) // sh + 1
        wo = (wp - (kw - 1) * dw - 1) // sw + 1
        xg = xh.reshape(b, hp, wp, g, ci)
        wg = weight.to(acc).view(g, co, ci, kh, kw)
        terms = [(iy, ix) for iy in range(kh) for ix in range(kw)] + [None] * (bias is not None)
        out = None
        for n, term in enumerate(terms, start=1):
            if term is None:
                t = bias.to(acc).view(g, co)
            else:
                iy, ix = term
                xs = xg[:, iy * dh: iy * dh + (ho - 1) * sh + 1: sh,
                        ix * dw: ix * dw + (wo - 1) * sw + 1: sw]
                t = torch.einsum("bhwgi,goi->bhwgo", xs, wg[:, :, :, iy, ix])
            if n < len(terms) or acc != dtype:
                out = t if out is None else out + t
                continue
            with remat.conv_out():  # the last op: its output is the result
                out = t.clone() if out is None else out + t
        if acc != dtype:
            with remat.conv_out():
                out = out.to(dtype)
    return out.reshape(b, ho, wo, feat).permute(0, 3, 1, 2)


class _LoweredConv2d(nn.Conv2d):
    """An nn.Conv2d with groups > 1 computed another way, holding the
    parameters of the conv it replaces (same names, same state dict)."""

    @classmethod
    def of(cls, conv: nn.Conv2d) -> "_LoweredConv2d":
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError(f"{cls.__name__}: zero padding by numbers only; got "
                             f"{conv.padding_mode!r}, {conv.padding!r}")
        new = cls(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                  conv.padding, conv.dilation, conv.groups, conv.bias is not None,
                  device="meta")
        new.weight, new.bias = conv.weight, conv.bias
        return new.train(conv.training)


class DenseGroupsConv2d(_LoweredConv2d):
    """The grouped conv as one dense conv of the block-diagonal weight: the
    JAX package's `groups_as_dense` lowering (:291-313), groups times the
    operations of the grouped conv."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, block_diagonal(self.weight, self.groups), self.bias, self.stride,
                        self.padding, self.dilation)


class EinsumGroupsConv2d(_LoweredConv2d):
    """The grouped conv as kh*kw shifted batched matmuls: the JAX package's
    `groups_as_einsum` lowering (:276-289), the grouped conv's operations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return grouped_conv_einsum(x, self.weight, self.bias, self.groups, self.stride,
                                   self.padding, self.dilation)


def lower_grouped_convs_(model: nn.Module, dense: Optional[str] = None,
                         einsum: Optional[str] = None) -> nn.Module:
    """Swap, in place, each nn.Conv2d of `model` with groups > 1 that the
    `einsum` spec selects for an EinsumGroupsConv2d and each other one that
    the `dense` spec selects for a DenseGroupsConv2d (specs as
    `dense_groups_include` reads them, over names relative to `model`; where
    both select a conv the einsum lowering wins, as in the JAX package). The
    parameters stay the same objects under the same names. Convs already
    lowered, and int8 convs, are left as they are."""
    lowerings = []
    for cls, spec in ((EinsumGroupsConv2d, einsum), (DenseGroupsConv2d, dense)):
        if spec is not None:
            include = dense_groups_include(spec)
            lowerings.append((cls, include or (lambda n: True)))
    for name, m in list(model.named_modules()):
        if type(m) is not nn.Conv2d or m.groups == 1:
            continue
        cls = next((c for c, include in lowerings if include(name)), None)
        if cls is not None:
            parent, _, child = name.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, child, cls.of(m))
    return model
