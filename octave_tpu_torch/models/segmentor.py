"""The OCTAve segmentor family: ResNeSt U-Nets with Adversarial Attention Gates.

The port of `octave_tpu/models/segmentor.py`:
  * AdversarialAttentionGate               :64-97
  * ResnestUNet (encoder gating, the
    classification heads)                  :100-108, :168-372
  * ResnestUnetParallelHead                :375-452
  * ResnestUnetParallelHeadAttentionGate   :455-558
Module names follow the reference torch state dict (`encoder_0_1_2`,
`encoder_1..4`, `encoder_{i}_gate.0`, `upsampling_i.up`, `decoder_i`,
`aag_i.conv1`, the dual decoders' `upsampling_{1,0}_c`, `decoder_{1,0}_c`,
`aag_{1,0}_c`, `fc`, `fc_c`, and the heads `linear_head_emb.1`,
`linear_head_dec.{1,3,4,6,8}`). The public boundary is NHWC, as in the JAX
package: `forward` takes (B,H,W,3) and returns NHWC tensors. `train()` /
`eval()` stand for the JAX package's `train` flag: in training the batch norms
use batch statistics and update their running stats once per forward, and
every gate runs the AAG kernel inside autograd.

Block remat (`remat_blocks`, `remat_save_convs`, `remat_enc_layers`, the JAX
segmentors' fields, :111-127, :186-215): True makes every encoder Bottleneck
and every decoder block (skip concat included; not the upsampling, not the
gate) its own recomputed region in training; "encoder" the Bottlenecks
only; a set of decoder depths those depths' blocks (both branches' for the
dual decoders) and the Bottlenecks. `remat_enc_layers` (1-based encoder
layers, True: all) narrows the Bottlenecks; `remat_save_convs` keeps each
region's conv outputs (`ops/remat.py`). The state dict and the eval path
are the same with or without.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.models.resnest import (
    ResNestDecoder,
    Upsampling,
    nchw,
    nhwc,
    resnest50,
    stem,
)
from octave_tpu_torch.ops.common import max_pool2d
from octave_tpu_torch.ops.kernels.aag import fused_aag
from octave_tpu_torch.ops.norm import BatchNorm2d

# decoder depth -> (Upsampling in, out, ResNestDecoder in, out)
_DECODER_WIDTHS = {
    0: (64, 64, 64, 32),
    1: (256, 64, 128, 64),
    2: (512, 256, 512, 256),
    3: (1024, 512, 1024, 512),
    4: (2048, 1024, 2048, 1024),
}
# channels of the encoder taps the encoder gates read: x_0_1, x_1 .. x_4
_ENCODER_WIDTHS = (64, 256, 512, 1024, 2048)


class AdversarialAttentionGate(nn.Module):
    """1x1 conv to K class logits, softmax over K, mask = sum of the non-
    background probabilities, x * mask. Runs as one fused pass: the Triton
    kernel on CUDA, its plain version on the CPU (ops/kernels/aag.py)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B,C,H,W) -> (masked x (B,C,H,W), y_hat (B,H,W,K)).

        Under autocast the kernel gates x rounded to the autocast dtype, as
        autocast runs the gate's 1x1 conv and as the JAX step casts the
        gate's input (the batch norm before it hands on float32), and writes
        x*mask in that dtype; y_hat, the attention pyramid, stays float32:
        the ILD's KL sends y_hat gradients beyond float16's range (at the 19²
        gate by the second step at 304², B = 8: 5.5e6 in bf16, 4.8e7 in
        float16; `scripts/f16_pyramid_grad.py` on an H100)."""
        k = self.conv1.out_channels
        dev = x.device.type
        autocast_dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else None
        out, yhat = fused_aag(nhwc(x), self.conv1.weight.view(k, -1).t(), self.conv1.bias,
                              autocast_dtype)
        return nchw(out), yhat


def pad_odd(x: torch.Tensor) -> Tuple[torch.Tensor, bool, bool]:
    """Zero-pad an odd H/W to even at the bottom/right (x_3 at 304²: 19 -> 20)."""
    down, right = x.shape[2] % 2 == 1, x.shape[3] % 2 == 1
    if down or right:
        x = F.pad(x, (0, int(right), 0, int(down)))
    return x, down, right


def crop_pad(d: torch.Tensor, down: bool, right: bool) -> torch.Tensor:
    """Undo `pad_odd` on an NCHW map."""
    return d[:, :, : d.shape[2] - int(down), : d.shape[3] - int(right)]


def apply_prediction_method(agg_map: torch.Tensor, method: str, dim: int = -1) -> torch.Tensor:
    """predict()'s post-processing: softmax | sigmoid | one-hot | original."""
    if method == "softmax":
        return torch.softmax(agg_map, dim=dim)
    if method == "sigmoid":
        return torch.sigmoid(agg_map)
    if method == "one-hot":
        hot = F.one_hot(agg_map.argmax(dim=dim), agg_map.shape[dim]).to(agg_map.dtype)
        return hot.movedim(-1, dim)
    if method == "original":
        return agg_map
    raise ValueError(f"Unknown prediction method: {method}")


def decoder_stage(decoder: ResNestDecoder, aag: AdversarialAttentionGate, skip, up,
                  gated: bool, fuse: bool, sink: List[torch.Tensor]) -> torch.Tensor:
    """One decoder depth of every gated variant: the decoder block on the
    (skip, up) pair, which it concatenates unless its first convs are int8
    (`skip` None: no skip), then, when gated, the attention gate, whose
    y_hat goes to `sink`. With `fuse` (eval only) a gated depth runs the
    decoder's tail and the gate as one fused epilogue kernel."""
    inp = up if skip is None else (skip, up)
    if not gated:
        return decoder(inp)
    if fuse:
        d, y = decoder(inp, gate=aag.conv1)
    else:
        d, y = aag(decoder(inp))
    sink.append(y)
    return d


class _ResnestEncoder(nn.Module):
    """The ResNeSt-50 encoder the three segmentors share, under the
    reference's `encoder_0_1_2` / `encoder_1..4` names, and the decoder
    blocks of `depths` (`upsampling_i`, `decoder_i`, `aag_i` when `gated`),
    with the block remat of the module docstring."""

    def __init__(self, remat_blocks=False, remat_save_convs: bool = False,
                 remat_enc_layers=True):
        super().__init__()
        self._remat = (remat_blocks, remat_save_convs, remat_enc_layers)

    def _build(self, num_classes: int, depths, gated: bool, suffix: str = "") -> None:
        blocks, save_convs, enc_layers = self._remat
        mode = "conv" if save_convs else True
        if not suffix:
            bb = resnest50(remat_blocks=blocks, remat_save_convs=save_convs,
                           remat_layers=enc_layers)
            self.encoder_0_1_2 = nn.Sequential(bb.conv1, bb.bn1, bb.relu)
            for i in range(1, 5):
                setattr(self, f"encoder_{i}", getattr(bb, f"layer{i}"))
        for depth in depths:
            ui, uo, di, do = _DECODER_WIDTHS[depth]
            setattr(self, f"upsampling_{depth}{suffix}", Upsampling(ui, uo))
            decoder = ResNestDecoder(di, do)
            if blocks is True or (isinstance(blocks, (set, frozenset, tuple, list))
                                  and depth in blocks):
                decoder.remat = mode
            setattr(self, f"decoder_{depth}{suffix}", decoder)
            if gated:
                setattr(self, f"aag_{depth}{suffix}", AdversarialAttentionGate(do, num_classes))

    def encode(self, x: torch.Tensor, taps: Optional[list] = None):
        """NHWC image -> (x_0_0, x_1, x_2, x_3 padded, x_4, down, right), NCHW
        maps. `taps`, when given, receives x_0_1, x_1, x_2, x_3 (unpadded)
        and x_4: what the encoder gates read."""
        conv1, bn1, _ = self.encoder_0_1_2  # its ReLU is bn1's `bn_act`
        x_0_0 = stem(conv1, bn1, nchw(x))
        x_0_1 = max_pool2d(x_0_0, 3, 2, 1)
        x_1 = self.encoder_1(x_0_1)
        x_2 = self.encoder_2(x_1)
        x_3 = self.encoder_3(x_2)
        x_3p, down, right = pad_odd(x_3)
        x_4 = self.encoder_4(x_3p)
        if taps is not None:
            taps.extend((x_0_1, x_1, x_2, x_3, x_4))
        return x_0_0, x_1, x_2, x_3p, x_4, down, right

    def idle_prefixes(self) -> Tuple[str, ...]:
        """State-dict prefixes of modules that `forward` never runs (the gates
        of ungated depths): a weight file may lack them."""
        return ()


class ResnestUNet(_ResnestEncoder):
    """ResNeSt-50 encoder + attention-gated U-Net decoder.

    Encoder taps 64/256/512/1024/2048 channels, decoder 1024/512/256/64/32,
    final 1x1 conv 32 -> num_classes. Depths <= gating_level are gated.
    With use_fused_decoder (eval only) each gated depth's decoder tail and
    gate run as one fused epilogue kernel; otherwise the gate is the fused
    AAG kernel after the plain decoder block.

    encoder_gating adds a 1x1 conv to 16 channels and a softmax over them on
    each encoder tap; `forward` then returns the five gate maps first.
    heads builds the classification heads of `classification_predict`. The
    JAX package creates their parameters only when that method initialises
    the module, so they are off by default and the default state dict has
    none."""

    def __init__(self, num_classes: int = 2, gating_level: int = 4,
                 use_fused_decoder: bool = False, encoder_gating: bool = False,
                 heads: bool = False, **remat_kw):
        super().__init__(**remat_kw)
        self.gating_level = gating_level
        self.use_fused_decoder = use_fused_decoder
        self.encoder_gating = encoder_gating
        self.heads = heads
        self._build(num_classes, range(5), gated=True)
        self.fc = nn.Conv2d(32, num_classes, 1)
        if encoder_gating:
            for i, c in enumerate(_ENCODER_WIDTHS):
                setattr(self, f"encoder_{i}_gate", nn.Sequential(nn.Conv2d(c, 16, 1),
                                                                 nn.Softmax(dim=1)))
        if heads:
            # index 0 of each stands where the reference pools (the callers
            # below pool themselves); the rest are the reference's layers
            self.linear_head_emb = nn.Sequential(nn.Flatten(1), nn.Linear(2048, num_classes))
            self.linear_head_dec = nn.Sequential(
                nn.AdaptiveAvgPool2d((32, 32)),
                nn.Conv2d(num_classes, 64, 7), nn.ReLU(), BatchNorm2d(64),
                nn.Conv2d(64, 512, 7), nn.ReLU(), BatchNorm2d(512),
                nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(1)),
                nn.Linear(512, num_classes))

    def idle_prefixes(self) -> Tuple[str, ...]:
        return tuple(f"aag_{d}." for d in range(5) if self.gating_level < d)

    def forward(self, x: torch.Tensor):
        """x (B,H,W,3) -> (attentions finest-first (B,h,w,K) each,
        agg_map (B,H,W,K), x_4 (B,h,w,2048)), all NHWC; with encoder_gating
        (gates (B,h,w,16) x 5, attentions, agg_map, x_4)."""
        taps = [] if self.encoder_gating else None
        x_0_0, x_1, x_2, x_3, x_4, down, right = self.encode(x, taps)
        attentions: List[torch.Tensor] = []
        fuse = self.use_fused_decoder and not self.training

        def stage(depth, skip, up):
            return decoder_stage(getattr(self, f"decoder_{depth}"), getattr(self, f"aag_{depth}"),
                                 skip, up, self.gating_level >= depth, fuse, attentions)

        d_4 = self.upsampling_4(x_4)
        d = stage(4, crop_pad(x_3, down, right), crop_pad(d_4, down, right))
        d = stage(3, x_2, self.upsampling_3(d))
        d = stage(2, x_1, self.upsampling_2(d))
        d = stage(1, x_0_0, self.upsampling_1(d))
        d = stage(0, None, self.upsampling_0(d))  # depth 0 has no skip
        agg_map = self.fc(d)
        attentions.reverse()
        out = (tuple(attentions), nhwc(agg_map), nhwc(x_4))
        if self.encoder_gating:
            gates = tuple(nhwc(getattr(self, f"encoder_{i}_gate")(t)) for i, t in enumerate(taps))
            return (gates,) + out
        return out

    def predict(self, x: torch.Tensor, method: str = "softmax"):
        """(attentions, apply_prediction_method(agg_map, method)), NHWC."""
        out = self(x)
        attentions, agg_map = (out[1], out[2]) if self.encoder_gating else (out[0], out[1])
        return attentions, apply_prediction_method(agg_map, method)

    def classification_predict(self, x: torch.Tensor, method: str, mode: str):
        """The classification heads: (class_pred (B,K), attentions, softmax
        agg map) or, for mode 'classic-gating', (class_pred, gates,
        attentions, softmax agg map). Modes: 'classic' (latent GAP ->
        linear_head_emb), 'classic-gating' (the same, needs encoder_gating),
        'ae-squash' (GAP of the prediction), 'ae-extract' (linear_head_dec on
        the prediction). Methods: softmax | sigmoid."""
        if mode == "classic-gating" and not self.encoder_gating:
            raise ValueError(f"{mode} is not valid if `encoder_gating` is not enabled.")
        if mode in ("classic", "classic-gating", "ae-extract") and not self.heads:
            raise ValueError(f"mode {mode!r} needs the classification heads: build the "
                             "model with heads=True")
        out = self(x)
        gates, (att, predicate, latent) = (out[0], out[1:]) if self.encoder_gating else (None, out)
        predicate = torch.softmax(predicate, dim=-1)
        if mode in ("classic", "classic-gating"):
            emb = self.linear_head_emb(latent.mean(dim=(1, 2)))
        elif mode == "ae-squash":
            emb = predicate.mean(dim=(1, 2))
        elif mode == "ae-extract":
            emb = self.linear_head_dec(nchw(predicate.contiguous()))
        else:
            raise NotImplementedError(f"classification mode {mode!r}")
        if method == "softmax":
            class_pred = torch.softmax(emb, dim=-1)
        elif method == "sigmoid":
            class_pred = torch.sigmoid(emb)
        else:
            raise NotImplementedError(f"classification method {method!r}")
        if mode == "classic-gating":
            return class_pred, gates, att, predicate
        return class_pred, att, predicate


class ResnestUnetParallelHead(_ResnestEncoder):
    """Dual-decoder (thick/thin) U-Net without gates: the main decoder as in
    ResnestUNet, and a second, shallow one from x_1 (`upsampling_{1,0}_c`,
    `decoder_{1,0}_c`, `fc_c`). Launches no kernel. `forward` returns the
    two agg maps stacked, (2, B, H, W, K)."""

    def __init__(self, num_classes: int = 2, **remat_kw):
        super().__init__(**remat_kw)
        self._build(num_classes, range(5), gated=False)
        self._build(num_classes, (1, 0), gated=False, suffix="_c")
        self.fc = nn.Conv2d(32, num_classes, 1)
        self.fc_c = nn.Conv2d(32, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_0_0, x_1, x_2, x_3, x_4, down, right = self.encode(x)
        d = self.upsampling_4(x_4)
        d = self.decoder_4(torch.cat([crop_pad(x_3, down, right), crop_pad(d, down, right)], 1))
        d = self.decoder_3(torch.cat([x_2, self.upsampling_3(d)], 1))
        d = self.decoder_2(torch.cat([x_1, self.upsampling_2(d)], 1))
        d = self.decoder_1(torch.cat([x_0_0, self.upsampling_1(d)], 1))
        d = self.decoder_0(self.upsampling_0(d))
        c = self.decoder_1_c(torch.cat([x_0_0, self.upsampling_1_c(x_1)], 1))
        c = self.decoder_0_c(self.upsampling_0_c(c))
        return torch.stack([nhwc(self.fc(d)), nhwc(self.fc_c(c))])

    def predict(self, x: torch.Tensor, method: str = "softmax") -> torch.Tensor:
        return apply_prediction_method(self(x), method)


class ResnestUnetParallelHeadAttentionGate(_ResnestEncoder):
    """The dual-decoder U-Net with gates: `aag_0..4` on the main decoder,
    `aag_1_c`, `aag_0_c` on the shallow one. Depth 4 is gated when
    gating_level > 3 (the reference's strict test), depths 3..0 when
    gating_level >= depth; the `_c` branch gates depths 1 and 0 only: seven
    gates at gating_level 4, six at 3. `forward` returns ((attentions,
    attentions_c), agg maps stacked (2, B, H, W, K)). use_fused_decoder
    (eval only) runs each gated depth as one fused epilogue kernel, as in
    ResnestUNet."""

    def __init__(self, num_classes: int = 2, gating_level: int = 3,
                 use_fused_decoder: bool = False, **remat_kw):
        super().__init__(**remat_kw)
        self.gating_level = gating_level
        self.use_fused_decoder = use_fused_decoder
        self._build(num_classes, range(5), gated=True)
        self._build(num_classes, (1, 0), gated=True, suffix="_c")
        self.fc = nn.Conv2d(32, num_classes, 1)
        self.fc_c = nn.Conv2d(32, num_classes, 1)

    def _gated(self, depth: int) -> bool:
        return self.gating_level > 3 if depth == 4 else self.gating_level >= depth

    def idle_prefixes(self) -> Tuple[str, ...]:
        return tuple(f"aag_{d}{s}." for d in range(5) for s in ("", "_c")
                     if not self._gated(d) and (not s or d <= 1))

    def forward(self, x: torch.Tensor):
        x_0_0, x_1, x_2, x_3, x_4, down, right = self.encode(x)
        attentions: List[torch.Tensor] = []
        attentions_c: List[torch.Tensor] = []
        fuse = self.use_fused_decoder and not self.training

        def stage(depth, skip, up, suffix="", sink=attentions):
            return decoder_stage(getattr(self, f"decoder_{depth}{suffix}"),
                                 getattr(self, f"aag_{depth}{suffix}"),
                                 skip, up, self._gated(depth), fuse, sink)

        d_4 = self.upsampling_4(x_4)
        d = stage(4, crop_pad(x_3, down, right), crop_pad(d_4, down, right))
        d = stage(3, x_2, self.upsampling_3(d))
        d = stage(2, x_1, self.upsampling_2(d))
        d = stage(1, x_0_0, self.upsampling_1(d))
        d = stage(0, None, self.upsampling_0(d))
        c = stage(1, x_0_0, self.upsampling_1_c(x_1), "_c", attentions_c)
        c = stage(0, None, self.upsampling_0_c(c), "_c", attentions_c)
        attentions.reverse()
        attentions_c.reverse()
        agg = torch.stack([nhwc(self.fc(d)), nhwc(self.fc_c(c))])
        return (tuple(attentions), tuple(attentions_c)), agg

    def predict(self, x: torch.Tensor, method: str = "softmax"):
        attentions, agg_map = self(x)
        return attentions, apply_prediction_method(agg_map, method)


ARCHITECTURES = {
    "unet": ResnestUNet,
    "parallel_head": ResnestUnetParallelHead,
    "parallel_head_gate": ResnestUnetParallelHeadAttentionGate,
}


def build_segmentor(architecture: str, num_classes: int = 2, gating_level: int = 4,
                    encoder_gating: bool = False, **kw) -> nn.Module:
    """The segmentor of `model.architecture` (unet | parallel_head |
    parallel_head_gate), as the JAX trainer builds it: gating_level goes to
    the gated ones, encoder_gating to ResnestUNet only, the remat fields
    (`remat_blocks`, `remat_save_convs`, `remat_enc_layers`) to all."""
    if architecture not in ARCHITECTURES:
        raise ValueError(f"unknown model.architecture {architecture!r}; expected "
                         f"{' | '.join(repr(a) for a in ARCHITECTURES)}")
    if encoder_gating and architecture != "unet":
        raise ValueError(f"model.encoder_gating is a ResnestUNet option; architecture "
                         f"{architecture!r} has no encoder gates")
    if architecture == "unet":
        return ResnestUNet(num_classes, gating_level, encoder_gating=encoder_gating, **kw)
    if architecture == "parallel_head":
        return ResnestUnetParallelHead(num_classes, **{k: v for k, v in kw.items()
                                                       if k.startswith("remat_")})
    return ResnestUnetParallelHeadAttentionGate(num_classes, gating_level, **kw)
