"""Device-side training augmentation, batched.

The port of `octave_tpu/data/augment.py` (:25-96): one random D4 dihedral
transform per sample (flips and a 90-degree rotation: en-face angiograms have
no canonical orientation) and an optional brightness/contrast jitter. The
geometric part is applied identically to every spatial tensor of a sample
(image, scribble one-hot, dense mask) BEFORE the critic's mask pyramid is
built (`preprocess.prepare_batch`), so the pyramid is the pyramid of the
augmented mask; flipping pyramid levels afterwards would not commute with
their ::2 nearest downsampling.

The randomness and the transform are kept apart: `draw` takes every random
number of one batch from an explicit torch.Generator, and `random_dihedral` /
`intensity_jitter` are pure functions of those draws (the JAX functions of
the same names split their key themselves).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Draws(NamedTuple):
    """One batch's random draws: three booleans per sample choose the D4
    element (rot90 after the flips), db and dc (b,1,1,1) are the jitter's
    brightness and contrast offsets, None without jitter."""

    flip_h: torch.Tensor
    flip_v: torch.Tensor
    rot: torch.Tensor
    db: Optional[torch.Tensor] = None
    dc: Optional[torch.Tensor] = None


def draw(generator: torch.Generator, batch: int, intensity: float = 0.0) -> Draws:
    """The draws of one batch, on the generator's device: fair coins for the
    dihedral bits and, with intensity > 0, db, dc ~ U(-intensity, intensity)."""
    dev = generator.device
    coins = torch.rand(3, batch, generator=generator, device=dev) < 0.5
    db = dc = None
    if intensity > 0.0:
        u = torch.rand(2, batch, 1, 1, 1, generator=generator, device=dev)
        db, dc = (u * 2.0 - 1.0) * intensity
    return Draws(coins[0], coins[1], coins[2], db, dc)


def random_dihedral(flip_h: torch.Tensor, flip_v: torch.Tensor, rot: torch.Tensor,
                    *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Apply each sample's D4 element to every (b, h, w, c) tensor: flip along
    w where flip_h, along h where flip_v, then transpose and flip along w
    where rot. h == w is required: the rotation changes the shape of a
    rectangle, so non-square inputs raise instead of degrading to the flip
    subgroup. The results are contiguous NHWC (flips and transposes alone
    would hand back strided views)."""
    for t in tensors:
        if t.shape[1] != t.shape[2]:
            raise ValueError("random_dihedral requires square spatial dims (rot90 is "
                             f"shape-changing on rectangles); got {t.shape[1]}x{t.shape[2]}."
                             " Resize to a square target first.")

    def apply(x: torch.Tensor) -> torch.Tensor:
        f = lambda m: m[:, None, None, None]  # noqa: E731
        x = torch.where(f(flip_h), x.flip(2), x)
        x = torch.where(f(flip_v), x.flip(1), x)
        x = torch.where(f(rot), x.transpose(1, 2).flip(2), x)
        return x.contiguous()

    return tuple(apply(t) for t in tensors)


def intensity_jitter(image: torch.Tensor, db: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """clip((x - mean) * (1 + dc) + mean + db, 0, 1) with the mean per sample.
    The image must be in [0, 1] (prepare_batch feeds it unstandardised
    grayscale): the clip would crush a standardised input. Labels are never
    touched."""
    mean = image.mean(dim=(1, 2, 3), keepdim=True)
    return ((image - mean) * (1.0 + dc.to(image.dtype)) + mean + db.to(image.dtype)).clamp(0.0, 1.0)


def augment(draws: Draws, image: torch.Tensor, scribble_onehot: torch.Tensor,
            mask_onehot: torch.Tensor,
            extra_labels: Tuple[torch.Tensor, ...] = ()) -> Tuple[torch.Tensor, ...]:
    """One augmentation of a prepared (pre-pyramid) batch: the dihedral part
    on the image, both label maps and every extra label map (e.g. the dual
    decoders' second-head scribbles), the jitter (when drawn) on the image
    only. Returns (image, scribble_onehot, mask_onehot, *extra_labels)."""
    out = random_dihedral(draws.flip_h, draws.flip_v, draws.rot,
                          image, scribble_onehot, mask_onehot, *extra_labels)
    image = out[0]
    if draws.db is not None:
        image = intensity_jitter(image, draws.db, draws.dc)
    return (image,) + out[1:]
