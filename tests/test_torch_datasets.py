"""The port's ROSE / OCTA-500 folder datasets against the JAX package's.

The on-disk trees the loaders document are built in tmp_path (as
tests/test_dataset_layouts.py builds them); every field of every Sample must
equal the JAX dataset's exactly, derived scribbles included, and the port's
Trainer must take a step and evaluate through `data.dataset=rose` and
`octa500`.
"""
import dataclasses
import struct
import zlib

import numpy as np
import pytest

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.data import datasets as jds
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.train.trainer import Trainer, build_dataset
from octave_tpu_torch.utils.config import Config


def _write_png_gray(path, arr):
    """Minimal 8-bit grayscale PNG writer (filter 0 rows)."""
    h, w = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _vessel_like(rng, hw):
    """A small grayscale image + thick/thin masks with vessel-ish structure."""
    h = w = hw
    mask = np.zeros((h, w), np.uint8)
    for _ in range(3):
        x = int(rng.integers(2, w - 3))
        mask[:, max(0, x - 1):x + 2] = 1  # 3px vertical 'vessel'
    thin = np.zeros_like(mask)
    cols = np.where(mask.any(0))[0][1::3]
    thin[:, cols] = mask[:, cols]
    img = (rng.uniform(30, 90, (h, w)) + mask * 120).clip(0, 255).astype(np.uint8)
    return img, mask * 255, thin * 255


def _build_rose(tmp_path, n_train=4, n_test=2, hw=40, thin=True, thick=False):
    """A ROSE-1/SVC tree; the train split gets thin_gt (and with `thick`,
    thick_gt: the vessels with every other band of 4 rows cut out)."""
    rng = np.random.default_rng(7)
    base = tmp_path / "ROSE-1" / "SVC"
    for split, n in (("train", n_train), ("test", n_test)):
        dirs = ["img", "gt"] + (["thin_gt"] if split == "train" and thin else []) + (
            ["thick_gt"] if split == "train" and thick else [])
        for d in dirs:
            (base / split / d).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, gt, thin_gt = _vessel_like(rng, hw)
            _write_png_gray(str(base / split / "img" / f"{i:02d}.png"), img)
            _write_png_gray(str(base / split / "gt" / f"{i:02d}.png"), gt)
            if "thin_gt" in dirs:
                _write_png_gray(str(base / split / "thin_gt" / f"{i:02d}.png"), thin_gt)
            if "thick_gt" in dirs:
                bands = (np.arange(hw) // 4 % 2 == 0)[:, None]
                _write_png_gray(str(base / split / "thick_gt" / f"{i:02d}.png"), gt * bands)
    return str(tmp_path)


def _build_octa500(tmp_path, n=3, hw=40):
    rng = np.random.default_rng(9)
    for split in ("train", "test"):
        for d in ("img", "gt"):
            (tmp_path / "OCTA_3M" / split / d).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, thick, _ = _vessel_like(rng, hw)
            _write_png_gray(str(tmp_path / "OCTA_3M" / split / "img" / f"{i}.png"), img)
            _write_png_gray(str(tmp_path / "OCTA_3M" / split / "gt" / f"{i}.png"), thick)
    return str(tmp_path)


def _assert_same_samples(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "scribble_c":
                assert a is None and b is None  # the single-head layouts carry none
                continue
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f"sample {i} {f.name}")
        assert want.scribble_c is None  # the single-head layouts carry no second target


@pytest.mark.parametrize("split", ["train", "test"])
def test_rose_samples_equal_jax(tmp_path, split):
    """thin_gt is THE scribble on the train split (class 2 = vessel); the
    test split has no scribble directory, so they are derived."""
    root = _build_rose(tmp_path)
    d = tds.rose(root, "ROSE-1/SVC", split)
    _assert_same_samples(d, jds.rose(root, "ROSE-1/SVC", split, dual=False))
    s = d[0]
    assert s.image.shape == (40, 40) and set(np.unique(s.mask)) <= {0, 1}
    assert set(np.unique(s.scribble)) <= ({0, 2} if split == "train" else {0, 1, 2})


@pytest.mark.parametrize("split", ["train", "test"])
def test_octa500_samples_equal_jax(tmp_path, split):
    """No scribble directories: centerline scribbles derived from the mask,
    with the same random background sample as the JAX dataset draws."""
    root = _build_octa500(tmp_path)
    d = tds.octa500(root, "3M", split)
    assert len(d) == 3
    _assert_same_samples(d, jds.octa500(root, "3M", split))
    assert (d[1].scribble == 1).any() and (d[1].scribble == 2).any()


def test_batches_equal_jax(tmp_path):
    root = _build_rose(tmp_path)
    got = next(tds.batch_iterator(tds.rose(root), 2, seed=3))
    want = next(jds.batch_iterator(jds.rose(root), 2, seed=3))
    assert set(got) == set(want) == {"image", "scribble", "mask"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dual_targets_and_bad_trees_raise(tmp_path):
    """The dual decoders' targets load: rose(dual=True) and an explicit
    scribble_c_dir give every sample a second-head scribble equal to the JAX
    dataset's; bad trees still raise."""
    root = _build_rose(tmp_path, thick=True)
    base = tmp_path / "ROSE-1" / "SVC" / "train"
    pairs = [(tds.rose(root, dual=True), jds.rose(root, dual=True)),
             (tds.ImageFolderOcta(str(base / "img"), str(base / "gt"),
                                  scribble_c_dir=str(base / "thin_gt")),
              jds.ImageFolderOcta(str(base / "img"), str(base / "gt"),
                                  scribble_c_dir=str(base / "thin_gt")))]
    for got, want in pairs:
        assert len(got) == len(want) == 4
        for i in range(4):  # one read each: derived scribbles draw from the dataset's rng
            a, b = got[i], want[i]
            for f in ("image", "scribble", "mask", "scribble_c"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f"sample {i} {f}")
            assert set(np.unique(a.scribble_c)) <= {0, 2}
    with pytest.raises(ValueError, match="mismatched/empty"):
        tds.ImageFolderOcta(str(base / "img"), str(tmp_path / "nowhere"))
    cfg = Config.from_dict({"data": {"dataset": "nosuch"}})
    with pytest.raises(ValueError, match="unknown dataset"):
        build_dataset(cfg)


def test_trainer_step_and_eval_through_rose(tmp_path):
    """40² files resized to the configured 32² on the device; one adversarial
    step and the dataset-level eval."""
    root = _build_rose(tmp_path)
    cfg = Config.from_dict({
        "model": {"discriminator_depth": 2, "num_filters": 8},
        "data": {"dataset": "rose", "root": root, "subset": "ROSE-1/SVC",
                 "image_size": (32, 32), "batch_size": 2},
        "train": {"steps": 1, "eval_every": 0, "log_every": 0},
    })
    tr = Trainer(cfg, device="cpu")
    assert isinstance(build_dataset(cfg, "test"), tds.ImageFolderOcta)
    state = tr.fit()
    assert state.step == 1
    m = tr.evaluate(state)
    assert np.isfinite(list(m.values())).all()
    assert 0.0 <= m["dice"] <= 1.0 and 0.0 <= m["auc"] <= 1.0


def test_trainer_eval_through_octa500(tmp_path):
    root = _build_octa500(tmp_path)
    cfg = Config.from_dict({
        "model": {"discriminator_depth": 0, "num_filters": 8},
        "data": {"dataset": "octa500", "root": root, "subset": "3M",
                 "image_size": (32, 32), "batch_size": 2},
        "train": {"steps": 0, "eval_every": 0, "log_every": 0},
    })
    tr = Trainer(cfg, device="cpu")
    m = tr.evaluate(tr.init_state())
    assert np.isfinite(list(m.values())).all()


class _Counted:
    """A dataset of integers that records which samples were loaded."""

    def __init__(self, n):
        self.n, self.loaded = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.loaded.append(i)
        v = np.full((1,), i, np.int64)
        return tds.Sample(v, v, v)


@pytest.mark.parametrize("n,batch_size,shuffle,drop_last",
                         [(7, 4, True, True), (10, 3, True, True), (10, 3, True, False),
                          (10, 3, False, True)])
def test_batch_iterator_start_yields_the_uninterrupted_tail(n, batch_size, shuffle, drop_last):
    """batch_iterator(start=k) yields batches k, k + 1, ... of the iterator
    that starts at 0, across epoch boundaries, and loads no skipped sample."""
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last, epochs=5)
    whole = [b["image"] for b in tds.batch_iterator(_Counted(n), batch_size, **kw)]
    for start in range(len(whole) + 1):
        data = _Counted(n)
        tail = [b["image"] for b in tds.batch_iterator(data, batch_size, start=start, **kw)]
        assert len(tail) == len(whole) - start
        for got, want in zip(tail, whole[start:]):
            np.testing.assert_array_equal(got, want)
        assert len(data.loaded) == sum(len(b) for b in tail)
