"""OctaScribbleNet: the OCTAve model facade (segmentor + critic + loss bundle).

The port of `octave_tpu/models/octa.py` (:32-184), with the reference
constructor's argument list, its `pretrian` spelling kept as an alias.
`forward(x, y)` runs the segmentor and, when a real mask pyramid `y` is
given, the critic on the attention pyramid and on `y`, as the JAX facade
does; shapes are NHWC. The critic's noise layers draw from the
`torch.Generator` passed to `forward` / `discriminate`.

Shape arguments may be (b, c, h, w) or (b, h, w, c): the smaller of dims 1
and 3 is taken as the channels. The module lives on `device`, CUDA unless the
caller passes "cpu".
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from octave_tpu_torch.losses.gan import ls_discriminator_loss, ls_generator_loss
from octave_tpu_torch.losses.segmentor import dice_loss, weighted_partial_ce
from octave_tpu_torch.models.discriminator import DiscriminatorBlock
from octave_tpu_torch.models.segmentor import ResnestUNet


def _shape_chw(shape: Sequence[int]) -> Tuple[int, int, int]:
    """(b,c,h,w) or (b,h,w,c) -> (c,h,w)."""
    _, a, b, c = shape
    if a <= c:  # NCHW
        return a, b, c
    return c, a, b


class OctaScribbleNet(nn.Module):
    """The ScribbleNet facade: `segmentor` (ResnestUNet) and, with
    discriminator_depth > 0, `discriminator` (DiscriminatorBlock over the
    finest-first attention pyramid). `is_training` sets the initial mode."""

    def __init__(self, raw_input_shape: Sequence[int], mask_input_shape: Sequence[int],
                 is_training: bool = True, num_classes: int = 2, num_filters: int = 64,
                 instance_noise: bool = True, label_noise: bool = True,
                 segmentor_gating_level: int = 4, discriminator_depth: int = 4,
                 encoder_gating: bool = False, weakly_supervise: bool = True,
                 device: str | torch.device = "cuda"):
        from octave_tpu_torch.serve import resolve_device  # serve imports this package

        super().__init__()
        device = resolve_device(device)
        self.raw_input_shape = tuple(raw_input_shape)
        self.mask_input_shape = tuple(mask_input_shape)
        self.num_classes = num_classes
        self.num_filters = num_filters
        self.discriminator_depth = discriminator_depth
        self.encoder_gating = encoder_gating
        self.weakly_supervise = weakly_supervise
        mc, mh, mw = _shape_chw(self.mask_input_shape)
        if mc != num_classes:
            warnings.warn("Number channels in mask input is not same as number of classes. "
                          "Can cause an error when model discriminator is in use.")
        self.segmentor = ResnestUNet(num_classes, gating_level=segmentor_gating_level,
                                     encoder_gating=encoder_gating)
        self.discriminator: Optional[DiscriminatorBlock] = None
        if discriminator_depth > 0:
            self.discriminator = DiscriminatorBlock(
                (mh, mw), depth=discriminator_depth, num_filters=num_filters,
                instance_noise=instance_noise, label_noise=label_noise, num_classes=num_classes)
        self.to(device).to(memory_format=torch.channels_last)
        self.train(is_training)

    def forward(self, x: torch.Tensor, y: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """x (b,h,w,c); y, optional, the finest-first real mask pyramid
        (discriminator_depth + 1 levels). Returns attentions, agg_map, latent
        (x_4), encoder_gates with encoder_gating, and the critic's y_fake and
        y_real logits (b, 1) when y is given and the critic exists."""
        out = self.segmentor(x)
        if self.encoder_gating:
            gates, attentions, agg_map, latent = out
        else:
            attentions, agg_map, latent = out
        result: Dict[str, Any] = {"attentions": attentions, "agg_map": agg_map,
                                  "latent": latent}
        if self.encoder_gating:
            result["encoder_gates"] = gates
        if self.discriminator is not None and y is not None:
            fake = list(attentions[: self.discriminator_depth + 1])
            result["y_fake"] = self.discriminator(fake, generator)
            result["y_real"] = self.discriminator(list(y), generator)
        return result

    def segment(self, x: torch.Tensor, method: str = "softmax"):
        return self.segmentor.predict(x, method)

    def discriminate(self, y: Sequence[torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.discriminator is None:
            raise ValueError("discriminator_depth is 0: the facade has no discriminator")
        return self.discriminator(list(y), generator)

    # -- the loss bundle ----------------------------------------------------
    def supervised_loss(self, y_hat: torch.Tensor, ys: torch.Tensor, **kwargs) -> torch.Tensor:
        """WeightedPartialCE(manual=True) when weakly supervised, else Dice."""
        if self.weakly_supervise:
            return weighted_partial_ce(y_hat, ys, self.num_classes, manual=True,
                                       ignore_bg=kwargs.get("ignore_bg", False),
                                       reduction=kwargs.get("reduction", "mean"),
                                       full=kwargs.get("full", False))
        return dice_loss(y_hat, ys)

    @staticmethod
    def discriminatorial_loss(y_real: torch.Tensor, y_fake: torch.Tensor) -> torch.Tensor:
        return ls_discriminator_loss(y_real, y_fake)

    @staticmethod
    def generator_loss(y_fake: torch.Tensor) -> torch.Tensor:
        return ls_generator_loss(y_fake)


def octa_scribble_net(
    raw_input_shape,
    mask_input_shape,
    is_training: bool,
    pretrian: bool = False,  # the reference's spelling
    weight_path: str = "resnest50-528c19ca.pth",
    num_classes: int = 2,
    num_filters: int = 64,
    instance_noise: bool = True,
    label_noise: bool = True,
    segmentor_gating_level: int = 4,
    discriminator_depth: int = 4,
    encoder_gating: bool = False,
    weakly_supervise: bool = True,
    pretrain: Optional[bool] = None,
    device: str | torch.device = "cuda",
) -> Tuple[OctaScribbleNet, Optional[str]]:
    """The reference constructor's argument list, `pretrian` included.
    Returns (module, weight_path if pretrained weights were asked for, else
    None): the weights are loaded explicitly, e.g. with
    `Trainer.load_pretrained_backbone`, not as a side effect."""
    use_pretrained = pretrain if pretrain is not None else pretrian
    model = OctaScribbleNet(
        raw_input_shape, mask_input_shape, is_training=is_training, num_classes=num_classes,
        num_filters=num_filters, instance_noise=instance_noise, label_noise=label_noise,
        segmentor_gating_level=segmentor_gating_level, discriminator_depth=discriminator_depth,
        encoder_gating=encoder_gating, weakly_supervise=weakly_supervise, device=device)
    return model, (weight_path if use_pretrained else None)
