"""ROSE / OCTA-500 folder datasets, the synthetic phantoms and host batching.

The port of `octave_tpu/data/datasets.py`, in numpy. The image-folder
datasets read the standard on-disk layouts:

ROSE, e.g. ROSE-1 SVC:
    <root>/ROSE-1/SVC/{train,test}/img/*.png
    <root>/ROSE-1/SVC/{train,test}/gt/*.png     (full vessel ground truth)
    <root>/ROSE-1/SVC/train/thin_gt             (centerline scribbles)
    <root>/ROSE-1/SVC/train/thick_gt            (pixel-level scribbles, head 0
                                                 of the dual decoders)
OCTA-500 (3M/6M projections):
    <root>/OCTA_3M/{train,test}/{img,gt}/*.bmp

through the port's C++ loader (`data/native.py`: PNG, BMP, PGM and TIFF,
threaded for a batch) where it builds, else through the numpy reader
`utils.imageio.read_image` (PNG, BMP, PGM; the two agree byte for byte),
as the JAX package falls back to its Python readers (:32-89); a TIFF
without the native loader raises IOError. `skeletonize_to_scribble` (:116-139),
`SyntheticOcta` (:215-258) and `batch_iterator` (:261-294, which stacks
`scribble_c` when every sample has one) give, with the
same seed, byte-identical arrays to the JAX package's: the random draws come
in the same order and every pixel of a vessel disc is decided by the same
float64 arithmetic; only the disc test is confined to the disc's bounding
box, which makes a 304² phantom much cheaper to draw.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from octave_tpu_torch.data import native
from octave_tpu_torch.utils.imageio import read_image

_IMG_EXTS = (".png", ".tif", ".tiff", ".bmp", ".jpg", ".jpeg", ".gif")


def _load_image(path: str) -> np.ndarray:
    """Read an image file to a (h, w) uint8 grayscale array: the native
    loader when it builds, else the numpy reader."""
    if native.available():
        return native.decode_image(path)
    return read_image(path)


def load_image_batch(paths, size) -> np.ndarray:
    """Decode a batch of files to (n, h, w) uint8 grayscale at `size`:
    ITU-R 601 luma for colour files, nearest resize with
    src = floor(dst * in / out); on the native loader's thread pool when it
    builds, else file by file in numpy."""
    paths = list(paths)
    if native.available():
        return native.load_batch(paths, size)
    h, w = size
    out = np.empty((len(paths), h, w), np.uint8)
    for i, p in enumerate(paths):
        img = _load_image(p)
        if img.shape != (h, w):
            sy = (np.arange(h, dtype=np.int64) * img.shape[0]) // h
            sx = (np.arange(w, dtype=np.int64) * img.shape[1]) // w
            img = img[sy[:, None], sx[None, :]]
        out[i] = img
    return out


def _list_images(d: str) -> List[str]:
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(_IMG_EXTS))


@dataclass
class Sample:
    image: np.ndarray  # (h, w) uint8
    scribble: np.ndarray  # (h, w) uint8 label map (0=unlabeled, 1=bg, 2=vessel)
    mask: np.ndarray  # (h, w) uint8 dense label (0=bg, 1=vessel)
    # the dual decoders' second-head target: the ROSE thin-branch scribbles
    scribble_c: Optional[np.ndarray] = None


def skeletonize_to_scribble(mask: np.ndarray, rng: np.random.Generator,
                            bg_fraction: float = 0.02) -> np.ndarray:
    """Centerline-style weak annotation from a dense mask: the morphological
    skeleton of the vessel map (scribble class 2) plus a sparse random sample
    of background pixels (scribble class 1)."""
    m = mask.astype(bool)
    try:
        from scipy.ndimage import binary_erosion, binary_opening

        # morphological skeleton: union over k of erode^k(A) minus its opening
        skel = np.zeros_like(m)
        eroded = m
        while eroded.any():
            skel |= eroded & ~binary_opening(eroded)
            eroded = binary_erosion(eroded)
    except ImportError:
        skel = m
    scrib = np.zeros_like(mask, dtype=np.uint8)
    scrib[skel] = 2
    bg = (~m) & (rng.random(mask.shape) < bg_fraction)
    scrib[bg] = 1
    return scrib


def _binarize(a: np.ndarray) -> np.ndarray:
    return (a > 127).astype(np.uint8)


class ImageFolderOcta:
    """Generic {img, gt[, scribble[, scribble_c]]} folder dataset. Without a
    scribble directory the scribbles are derived from the mask's skeleton;
    `scribble_c_dir` gives each sample a second-head target."""

    def __init__(self, img_dir: str, gt_dir: str, scribble_dir: Optional[str] = None,
                 seed: int = 0, scribble_c_dir: Optional[str] = None):
        self.images = _list_images(img_dir)
        self.gts = _list_images(gt_dir)
        if len(self.images) != len(self.gts) or not self.images:
            raise ValueError(f"mismatched/empty dataset: {img_dir} ({len(self.images)}) vs "
                             f"{gt_dir} ({len(self.gts)})")
        self.scribbles = _list_images(scribble_dir) if scribble_dir else []
        self.scribbles_c = _list_images(scribble_c_dir) if scribble_c_dir else []
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    @staticmethod
    def _to_scribble(path: str, mask: np.ndarray) -> np.ndarray:
        """A binary annotation file -> scribble map (vessel pixels class 2)."""
        scrib = np.zeros_like(mask, dtype=np.uint8)
        scrib[_binarize(_load_image(path)).astype(bool)] = 2
        return scrib

    def __getitem__(self, i: int) -> Sample:
        img = _load_image(self.images[i])
        mask = _binarize(_load_image(self.gts[i]))
        if self.scribbles:
            scrib = self._to_scribble(self.scribbles[i], mask)
        else:
            scrib = skeletonize_to_scribble(mask, self._rng)
        scrib_c = self._to_scribble(self.scribbles_c[i], mask) if self.scribbles_c else None
        return Sample(img, scrib, mask, scribble_c=scrib_c)


def rose(root: str, subset: str = "ROSE-1/SVC", split: str = "train",
         dual: bool = False) -> ImageFolderOcta:
    """ROSE layout: the centerline (`thin_gt`) annotations are the weak
    scribbles, as in the paper's weakly-supervised setup. With `dual=True`
    (the dual decoders' per-head targets) head 0 takes the pixel-level
    `thick_gt` and head 1 (`scribble_c`) the centerline `thin_gt`."""
    base = os.path.join(root, subset, split)
    thin = os.path.join(base, "thin_gt")
    if dual:
        thick = os.path.join(base, "thick_gt")
        return ImageFolderOcta(os.path.join(base, "img"), os.path.join(base, "gt"),
                               thick if os.path.isdir(thick) else None,
                               scribble_c_dir=thin if os.path.isdir(thin) else None)
    return ImageFolderOcta(os.path.join(base, "img"), os.path.join(base, "gt"),
                           thin if os.path.isdir(thin) else None)


def octa500(root: str, fov: str = "3M", split: str = "train") -> ImageFolderOcta:
    """OCTA-500 layout: no scribble directory, so scribbles are derived."""
    base = os.path.join(root, f"OCTA_{fov}", split)
    return ImageFolderOcta(os.path.join(base, "img"), os.path.join(base, "gt"))


class SyntheticOcta:
    """Vessel phantoms: random smooth quadratic vessel paths of radius 1 to
    3.5 px on gamma speckle, with scribbles derived from the mask."""

    def __init__(self, size: Tuple[int, int] = (304, 304), n: int = 64, seed: int = 0,
                 cache: bool = True):
        self.size = size
        self.n = n
        self.seed = seed
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Sample:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        s = self._generate(i)
        if self._cache is not None:
            self._cache[i] = s
        return s

    def _generate(self, i: int) -> Sample:
        h, w = self.size
        rng = np.random.default_rng(self.seed * 100003 + i)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rng.integers(6, 14)):
            x0, x1 = rng.uniform(0, w, 2)
            xm = rng.uniform(0, w)
            t = np.linspace(0, 1, max(h, w) * 2)
            px = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * xm + t**2 * x1
            py = t * (h - 1)
            r = rng.uniform(1.0, 3.5)
            for cx, cy in zip(px[:: max(1, len(px) // 256)], py[:: max(1, len(py) // 256)]):
                # only pixels within r of the centre can pass the disc test
                ya, yb = max(int(np.floor(cy - r)), 0), min(int(np.floor(cy + r)) + 1, h)
                xa, xb = max(int(np.floor(cx - r)), 0), min(int(np.floor(cx + r)) + 1, w)
                if ya >= yb or xa >= xb:
                    continue
                yy, xx = np.mgrid[ya:yb, xa:xb]
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                mask[ya:yb, xa:xb][d2 <= r * r] = 1
        speckle = rng.gamma(2.0, 0.12, (h, w))
        img = np.clip(speckle + mask * rng.uniform(0.35, 0.6), 0, 1)
        img8 = (img * 255).astype(np.uint8)
        scrib = skeletonize_to_scribble(mask, rng)
        return Sample(img8, scrib, mask)


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epochs: Optional[int] = None,
    start: int = 0,
) -> Iterator[dict]:
    """Host-side batching into contiguous numpy arrays (the device transform
    is `data.preprocess.prepare_batch`).

    `start` skips the first `start` batches of the sequence: the iterator
    yields what an uninterrupted one yields from batch `start` on (a run
    resumed at step s passes s). It draws each skipped epoch's permutation
    and loads no skipped sample."""
    n = len(dataset)
    if drop_last and n < batch_size:
        # without this the epoch loop yields nothing and spins forever
        raise ValueError(f"batch_size {batch_size} > dataset size {n} with drop_last — "
                         "the iterator would never yield a batch")
    rng = np.random.default_rng(seed)
    stop = n - (n % batch_size) if drop_last else n
    epoch, skip = divmod(start, max(-(-stop // batch_size), 1))
    for _ in range(epoch if shuffle else 0):
        rng.permutation(n)
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        first, skip = skip * batch_size, 0
        for s in range(first, stop, batch_size):
            samples = [dataset[int(i)] for i in order[s: s + batch_size]]
            batch = {
                "image": np.stack([x.image for x in samples]),
                "scribble": np.stack([x.scribble for x in samples]),
                "mask": np.stack([x.mask for x in samples]),
            }
            if all(x.scribble_c is not None for x in samples):
                batch["scribble_c"] = np.stack([x.scribble_c for x in samples])
            yield batch
        epoch += 1
