"""Vessel phantoms: the benchmark's inputs, made from the seed.

`device_phantoms` draws en-face angiogram phantoms on the GPU in a few large
calls (the serving traffic and the int8 calibration set): 6 to 13 smooth
quadratic vessels of radius 1 to 3.5 px, each pixel within a vessel's radius
of its centre line (the distance taken across the line's local slope), on
gamma(2, 0.12) speckle, the vessels brightened by U(0.35, 0.6).

`SyntheticOcta` is a frozen copy of the program's training phantoms
(`octave_tpu_torch/data/datasets.py::SyntheticOcta` with
`skeletonize_to_scribble`, and the order `batch_iterator` draws), so that the
reference regenerates the batches the program trains on from the same seed
without taking them from the program. A test holds the copy to the program's
arrays byte for byte.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def device_phantoms(n: int, hw: int, generator: torch.Generator,
                    chunk: int = 32) -> torch.Tensor:
    """(n, hw, hw) uint8 phantoms on the generator's device."""
    dev = generator.device
    out = torch.empty((n, hw, hw), dtype=torch.uint8, device=dev)
    ys = torch.arange(hw, device=dev, dtype=torch.float32)
    xs = ys.view(1, 1, 1, hw)
    t = (ys / (hw - 1)).view(1, 1, hw)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        u = torch.rand((m, 14, 6), generator=generator, device=dev)
        count = 6 + (u[:, 0, 5] * 8).long().clamp(max=7)  # 6..13 vessels
        live = torch.arange(14, device=dev).view(1, 14) < count.view(m, 1)
        x0, xm, x1 = (u[..., i:i + 1] * hw for i in range(3))  # (m, 14, 1)
        r = 1.0 + 2.5 * u[..., 3:4]
        cx = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * xm + t ** 2 * x1  # (m, 14, hw)
        slope = (2 * (1 - t) * (xm - x0) + 2 * t * (x1 - xm)) / (hw - 1)
        dist = (xs - cx.unsqueeze(-1)).abs() / torch.sqrt(1 + slope ** 2).unsqueeze(-1)
        vessel = ((dist <= r.unsqueeze(-1)) & live.view(m, 14, 1, 1)).any(dim=1)
        e = torch.rand((2, m, hw, hw), generator=generator, device=dev).clamp_(min=1e-12)
        speckle = -0.12 * torch.log(e).sum(dim=0)  # gamma(2, 0.12)
        bright = 0.35 + 0.25 * torch.rand((m, 1, 1), generator=generator, device=dev)
        img = (speckle + vessel * bright).clamp_(0, 1)
        out[lo:lo + m] = (img * 255).to(torch.uint8)
    return out


def as_rgb(images: torch.Tensor) -> torch.Tensor:
    """(n, h, w) grayscale -> (n, h, w, 3), as the serving wire takes it."""
    return images.unsqueeze(-1).expand(*images.shape, 3).contiguous()


# -- the frozen copy of the program's training phantoms -------------------------


def skeletonize_to_scribble(mask: np.ndarray, rng: np.random.Generator,
                            bg_fraction: float = 0.02) -> np.ndarray:
    """Centre-line scribbles (class 2) from the mask's morphological
    skeleton, plus 2% of the background pixels (class 1)."""
    from scipy.ndimage import binary_erosion, binary_opening

    m = mask.astype(bool)
    skel = np.zeros_like(m)
    eroded = m
    while eroded.any():
        skel |= eroded & ~binary_opening(eroded)
        eroded = binary_erosion(eroded)
    scrib = np.zeros_like(mask, dtype=np.uint8)
    scrib[skel] = 2
    scrib[(~m) & (rng.random(mask.shape) < bg_fraction)] = 1
    return scrib


def synthetic_octa(i: int, seed: int, size: Tuple[int, int]) -> Tuple[np.ndarray, ...]:
    """(image, scribble, mask) of training phantom i of `seed`."""
    h, w = size
    rng = np.random.default_rng(seed * 100003 + i)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(rng.integers(6, 14)):
        x0, x1 = rng.uniform(0, w, 2)
        xm = rng.uniform(0, w)
        t = np.linspace(0, 1, max(h, w) * 2)
        px = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * xm + t ** 2 * x1
        py = t * (h - 1)
        r = rng.uniform(1.0, 3.5)
        for cx, cy in zip(px[:: max(1, len(px) // 256)], py[:: max(1, len(py) // 256)]):
            ya, yb = max(int(np.floor(cy - r)), 0), min(int(np.floor(cy + r)) + 1, h)
            xa, xb = max(int(np.floor(cx - r)), 0), min(int(np.floor(cx + r)) + 1, w)
            if ya >= yb or xa >= xb:
                continue
            yy, xx = np.mgrid[ya:yb, xa:xb]
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[ya:yb, xa:xb][d2 <= r * r] = 1
    speckle = rng.gamma(2.0, 0.12, (h, w))
    img = np.clip(speckle + mask * rng.uniform(0.35, 0.6), 0, 1)
    return (img * 255).astype(np.uint8), skeletonize_to_scribble(mask, rng), mask


def batch_indices(n: int, batch: int, seed: int, count: int) -> np.ndarray:
    """The dataset indices of the first `count` shuffled batches (drop_last),
    as (count, batch)."""
    rng = np.random.default_rng(seed)
    stop = n - n % batch
    rows = []
    while len(rows) < count:
        order = rng.permutation(n)
        rows += [order[s:s + batch] for s in range(0, stop, batch)]
    return np.stack(rows[:count])
