"""Device-side preprocessing: raw host batch -> model-ready NHWC tensors.

The port of `octave_tpu/data/preprocess.py` (:26-176):

    raw uint8 (b,h,w[,1]) -> float [0,1] -> bilinear resize to the target ->
    grayscale tiled to the stem's channels; scribble label map -> one-hot;
    dense mask -> one-hot; optional train-time augmentation of all three
    (data/augment.py); augmented mask -> finest-first pyramid for the critic's
    real branch.

Everything after the upload runs on the tensors' device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from octave_tpu_torch.data.augment import Draws, augment
from octave_tpu_torch.ops.common import avg_pool2d, nearest_resize


def to_float(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; a float input passes through as float32."""
    if img.is_floating_point():
        return img.float()
    return img.float() / 255.0


def ensure_nhwc(img: torch.Tensor) -> torch.Tensor:
    """(b,h,w) -> (b,h,w,1)."""
    return img[..., None] if img.ndim == 3 else img


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """(b,h,w[,c]) uint8 or float -> float32 NHWC in [0, 1]: the reference
    trains on [0, 1] grayscale, unstandardised."""
    return to_float(ensure_nhwc(img))


def resize_or_pad(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC float image to `size`, antialiased when it
    shrinks, as `jax.image.resize(..., "bilinear")` is."""
    if tuple(img.shape[1:3]) == tuple(size):
        return img
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()


def grayscale_to_channels(img: torch.Tensor, channels: int) -> torch.Tensor:
    """Tile a 1-channel NHWC image to `channels` (the ResNeSt stem takes 3)."""
    img = ensure_nhwc(img)
    if img.shape[-1] == channels:
        return img
    if img.shape[-1] != 1:
        raise ValueError(f"cannot adapt {img.shape[-1]}->{channels} channels")
    return img.expand(*img.shape[:-1], channels).contiguous()


def scribble_to_onehot(scribble: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Scribble label map (b,h,w) -> one-hot (b,h,w,c): 0 is unannotated (all
    zeros), v in 1..num_classes is a scribble of class v-1."""
    v = scribble.long()
    return F.one_hot((v - 1).clamp(min=0), num_classes).float() * (v > 0)[..., None]


def mask_to_onehot(mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Dense label mask (b,h,w) -> one-hot (b,h,w,c) with background channel 0."""
    return F.one_hot(mask.long(), num_classes).float()


def mask_pyramid(mask: torch.Tensor, depth: int,
                 method: str = "nearest") -> Tuple[torch.Tensor, ...]:
    """Finest-first pyramid of a one-hot (b,h,w,c) mask, level i at h/2^i:
    'nearest' keeps hard {0,1} maps, 'avg' gives 2x2-averaged soft maps."""
    levels = [mask]
    cur = mask
    for _ in range(depth):
        h, w = cur.shape[1] // 2, cur.shape[2] // 2
        if method == "nearest":
            cur = nearest_resize(cur, (h, w))
        elif method == "avg":
            cur = avg_pool2d(cur.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()
        else:
            raise ValueError(f"unknown pyramid method: {method}")
        levels.append(cur)
    return tuple(levels)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; CUDA uploads go through pinned memory
    without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prepare_batch(
    image: np.ndarray,
    scribble: np.ndarray,
    full_mask: np.ndarray,
    size: Tuple[int, int] = (304, 304),
    num_classes: int = 2,
    depth: int = 4,
    in_channels: int = 3,
    augment_draws: Optional[Draws] = None,
    scribble_c: Optional[np.ndarray] = None,
    *,
    device: torch.device | str,
) -> Dict[str, object]:
    """Raw host batch -> dict(image (b,h,w,in_channels), scribble_onehot,
    mask_onehot (b,h,w,num_classes), mask_pyramid[, scribble_onehot_c]) on
    `device`. Label maps resize with nearest, never bilinear. `scribble_c`,
    the dual decoders' second-head scribbles, takes the scribbles' path and
    comes back as scribble_onehot_c. With `augment_draws` (`augment.draw`),
    image, scribbles and mask get one D4 transform per sample, the same for
    all of them, and the image its jitter, before the pyramid is built:
    train time only."""
    device = torch.device(device)
    image, scribble, full_mask = (to_device(a, device) for a in (image, scribble, full_mask))

    def label_map(a: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape[1:3]) != tuple(size):
            a = nearest_resize(a[..., None], size)[..., 0]
        return a

    img = grayscale_to_channels(resize_or_pad(normalize_image(image), size), in_channels)
    scrib = scribble_to_onehot(label_map(scribble), num_classes)
    dense = mask_to_onehot(label_map(full_mask), num_classes)
    extras = ()
    if scribble_c is not None:
        extras = (scribble_to_onehot(label_map(to_device(scribble_c, device)), num_classes),)
    if augment_draws is not None:
        img, scrib, dense, *extras = augment(augment_draws, img, scrib, dense, tuple(extras))
    batch = {
        "image": img,
        "scribble_onehot": scrib,
        "mask_onehot": dense,
        "mask_pyramid": mask_pyramid(dense, depth),
    }
    if extras:
        batch["scribble_onehot_c"] = extras[0]
    return batch
