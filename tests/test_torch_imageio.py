"""The port's dependency-free image reader and writer on the CPU.

`read_image` against arrays written by hand-made PNG / BMP / PGM encoders
(those of tests/test_native_loader.py, copied, plus a PNG encoder that can
apply each of the five row filters and write colour, palette, 16-bit and
sub-byte files), against the JAX package's C++ loader where that library
builds, and `load_image_batch` against the JAX package's on the same files.

Where the two packages differ: a colour PNG. The port turns colour to grey
by the ITU-R 601 luma that `load_image_batch` documents; the C++ loader does
so for BMP only and leaves PNGs to libpng's default weights (Rec. 709), so
the two read a random RGB PNG up to 33 grey levels apart
(`test_rgb_png_is_601_luma`). The JAX package's pure-Python path (PIL, then
601 luma) and the port agree exactly.
"""
import struct
import unittest.mock as mock
import zlib

import numpy as np
import pytest

from octave_tpu.data import datasets as jds
from octave_tpu.data import native
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.utils.imageio import read_image, write_png_gray


def _png_filter_row(ftype, row, prev, bpp):
    """One PNG-filtered row (bytes) of `row` given the row above."""
    row, prev = row.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return bytes([ftype]) + ((row - pred) % 256).astype(np.uint8).tobytes()


def _write_png(path, rows, w, h, depth, color, bpp, ftype=0, palette=None):
    """PNG from already-packed sample rows (h, rowbytes) uint8; ftype 0-4, or
    5 to cycle through all five filters row by row."""
    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    raw, prev = b"", np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        raw += _png_filter_row(y % 5 if ftype == 5 else ftype, rows[y], prev, bpp)
        prev = rows[y]
    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", palette.tobytes())
    png += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def _write_png_gray(path, arr, ftype=0):
    _write_png(path, arr, arr.shape[1], arr.shape[0], 8, 0, 1, ftype)


def _write_bmp_gray8(path, arr):
    """8bpp palettized grayscale BMP (bottom-up)."""
    h, w = arr.shape
    stride = (w + 3) & ~3
    palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
    rows = b"".join(arr[y].tobytes() + b"\x00" * (stride - w) for y in range(h - 1, -1, -1))
    off = 14 + 40 + len(palette)
    header = (b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(rows), 0, 0, 256, 0))
    with open(path, "wb") as f:
        f.write(header + palette + rows)


def _write_bmp_rgb(path, rgb, bpp=24, topdown=False):
    h, w, _ = rgb.shape
    px = rgb[..., ::-1]  # BGR
    if bpp == 32:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    stride = ((w * bpp + 31) // 32) * 4
    order = range(h) if topdown else range(h - 1, -1, -1)
    rows = b"".join(px[y].tobytes() + b"\x00" * (stride - w * bpp // 8) for y in order)
    header = (b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, -h if topdown else h, 1, bpp, 0,
                            len(rows), 0, 0, 0, 0))
    with open(path, "wb") as f:
        f.write(header + rows)


def _write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5 {w} {h} 255\n".encode() + arr.tobytes())


WRITERS = {"png": _write_png_gray, "bmp": _write_bmp_gray8, "pgm": _write_pgm}


def _luma601(rgb):
    c = rgb.astype(np.uint32)
    return ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8)


@pytest.fixture()
def gray(rng):
    return rng.integers(0, 256, (37, 53), dtype=np.uint8)


def _native():
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.build_error()}")
    return native


@pytest.mark.parametrize("fmt", ["png", "bmp", "pgm"])
def test_roundtrip_exact(tmp_path, gray, fmt):
    p = str(tmp_path / f"x.{fmt}")
    WRITERS[fmt](p, gray)
    out = read_image(p)
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, gray)


@pytest.mark.parametrize("fmt", ["png", "bmp", "pgm"])
def test_equals_native_decoder(tmp_path, gray, fmt):
    p = str(tmp_path / f"x.{fmt}")
    WRITERS[fmt](p, gray)
    np.testing.assert_array_equal(read_image(p), _native().decode_image(p))


def test_write_png_gray_roundtrip_and_float(tmp_path, gray):
    p = str(tmp_path / "w.png")
    write_png_gray(p, gray)
    np.testing.assert_array_equal(read_image(p), gray)
    if native.available():
        np.testing.assert_array_equal(native.decode_image(p), gray)
    write_png_gray(p, gray.astype(np.float32) / 255.0)
    assert np.abs(read_image(p).astype(int) - gray.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        write_png_gray(p, np.zeros((2, 2, 3), np.uint8))


@pytest.mark.parametrize("fmt", ["png", "bmp", "pgm"])
def test_sniff_without_extension(tmp_path, gray, fmt):
    """The format comes from the file's first bytes, not from its name."""
    p = str(tmp_path / "mystery.dat")
    WRITERS[fmt](p, gray)
    np.testing.assert_array_equal(read_image(p), gray)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, 5])
def test_png_row_filters(tmp_path, gray, ftype):
    p = str(tmp_path / "f.png")
    _write_png_gray(p, gray, ftype)
    np.testing.assert_array_equal(read_image(p), gray)
    if native.available():
        np.testing.assert_array_equal(native.decode_image(p), gray)


def test_rgb_png_is_601_luma(tmp_path, rng):
    """Colour PNG -> grey by (299 R + 587 G + 114 B) // 1000, equal to the JAX
    package's pure-Python `load_image_batch`; the C++ loader's libpng weights
    differ from it by at most 33 levels."""
    rgb = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    _write_png(p, rgb.reshape(19, -1), 23, 19, 8, 2, 3, ftype=5)
    got = read_image(p)
    np.testing.assert_array_equal(got, _luma601(rgb))
    pytest.importorskip("PIL")
    with mock.patch.object(native, "available", lambda: False):
        np.testing.assert_array_equal(jds.load_image_batch([p], (19, 23))[0], got)
    np.testing.assert_array_equal(tds.load_image_batch([p], (19, 23))[0], got)
    if native.available():
        diff = np.abs(native.decode_image(p).astype(int) - got.astype(int))
        assert 0 < diff.max() <= 33, diff.max()


def test_png_variants(tmp_path, rng):
    """RGBA, gray+alpha, palette, 16-bit and sub-byte gray, as libpng reads
    them (alpha dropped, high byte kept, sub-byte gray scaled to 0..255)."""
    h, w = 9, 11
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    p = str(tmp_path / "rgba.png")
    _write_png(p, rgba.reshape(h, -1), w, h, 8, 6, 4, ftype=4)
    np.testing.assert_array_equal(read_image(p), _luma601(rgba))
    ga = rng.integers(0, 256, (h, w, 2), dtype=np.uint8)
    p = str(tmp_path / "ga.png")
    _write_png(p, ga.reshape(h, -1), w, h, 8, 4, 2, ftype=3)
    np.testing.assert_array_equal(read_image(p), ga[..., 0])
    g16 = rng.integers(0, 65536, (h, w)).astype(">u2")
    p = str(tmp_path / "g16.png")
    _write_png(p, g16.view(np.uint8).reshape(h, -1), w, h, 16, 0, 2, ftype=1)
    np.testing.assert_array_equal(read_image(p), (g16 >> 8).astype(np.uint8))
    if native.available():
        np.testing.assert_array_equal(native.decode_image(p), read_image(p))
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (h, w), dtype=np.uint8)
    p = str(tmp_path / "pal.png")
    _write_png(p, idx, w, h, 8, 3, 1, palette=pal)
    np.testing.assert_array_equal(read_image(p), _luma601(pal[idx]))
    for depth in (1, 2, 4):
        vals = rng.integers(0, 1 << depth, (h, w), dtype=np.uint8)
        bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
        packed = np.packbits(bits.reshape(h, -1), axis=1)
        p = str(tmp_path / f"g{depth}.png")
        _write_png(p, packed, w, h, depth, 0, 1, ftype=2)
        want = vals * (255 // ((1 << depth) - 1))
        np.testing.assert_array_equal(read_image(p), want)
        if native.available():
            np.testing.assert_array_equal(native.decode_image(p), want)


@pytest.mark.parametrize("bpp,topdown", [(24, False), (32, False), (24, True)])
def test_bmp_colour_matches_native(tmp_path, rng, bpp, topdown):
    rgb = rng.integers(0, 256, (7, 10, 3), dtype=np.uint8)  # 30-byte rows: padded to 32
    p = str(tmp_path / "c.bmp")
    _write_bmp_rgb(p, rgb, bpp, topdown)
    np.testing.assert_array_equal(read_image(p), _luma601(rgb))
    if native.available():
        np.testing.assert_array_equal(native.decode_image(p), read_image(p))


def _bmp_header(size, data_off, w, h, bpp, colours):
    return (b"BM" + struct.pack("<IHHI", size, 0, 0, data_off)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, 0, 0, 0, colours, 0))


MALFORMED = {
    # 8bpp BMP whose pixel data starts right after the headers: no palette
    "bmp_truncated_palette": _bmp_header(54 + 16, 54, 4, 4, 8, 256) + bytes(16),
    # a 2**20 x 2**20 image in a 60-byte file: refused before any allocation
    "bmp_huge_dims": _bmp_header(60, 1078, 1 << 20, 1 << 20, 8, 256) + bytes(6),
    "bmp_data_offset_past_eof": _bmp_header(60, 1 << 30, 4, 4, 24, 0) + bytes(6),
    "pgm_absurd_dims": b"P5 999999999 999999999 255\n",
    "pgm_truncated": b"P5 8 8 255\n" + bytes(10),
    "png_truncated": None,  # filled in the test from a valid file
    "unknown_format": b"GIF89a" + bytes(32),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_files_raise_ioerror(tmp_path, gray, case):
    p = str(tmp_path / "bad.bin")
    data = MALFORMED[case]
    if case == "png_truncated":
        _write_png_gray(p, gray)
        data = open(p, "rb").read()[:-40]
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(IOError):
        read_image(p)


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        read_image(str(tmp_path / "nope.png"))


def test_load_image_batch_equals_jax(tmp_path, rng):
    """Same files, same target size: the same pixels as the JAX package's
    `load_image_batch` (its threaded C++ path where built, else its Python
    path), exact size and nearest-resized alike."""
    paths, arrays = [], []
    for i, fmt in enumerate(["png", "bmp", "pgm", "png", "pgm", "bmp"]):
        a = rng.integers(0, 256, (32 + i, 48 - i), dtype=np.uint8)
        p = str(tmp_path / f"b{i}.{fmt}")
        WRITERS[fmt](p, a)
        paths.append(p)
        arrays.append(a)
    for size in ((32, 48), (16, 16), (40, 60)):
        got = tds.load_image_batch(paths, size)
        assert got.shape == (6, *size) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jds.load_image_batch(paths, size))
    np.testing.assert_array_equal(tds.load_image_batch(paths, (32, 48))[0], arrays[0])
    a = arrays[3]  # 35x45 -> 32x48: src = floor(dst * in / out)
    want = a[(np.arange(32) * 35) // 32][:, (np.arange(48) * 45) // 48]
    np.testing.assert_array_equal(tds.load_image_batch(paths, (32, 48))[3], want)
    with pytest.raises(IOError):
        tds.load_image_batch([str(tmp_path / "nope.png")], (8, 8))
