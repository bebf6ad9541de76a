"""The port's C++ image loader (`octave_tpu_torch/data/native.py`) on the CPU.

Held against the JAX package's C++ loader on grey PNG, BMP and PGM (single
files and threaded batches with resize), against pillow (through the JAX
package's `load_image_batch`, whose Python path reads TIFF with pillow) on
the committed TIFF fixtures, and against the port's numpy reader
`utils.imageio.read_image` on every PNG row filter and colour type. All
comparisons are exact: the decoders compute integers. Hostile headers must
come back as IOError, never as a crash, and six processes building the
library at once must leave one good library.

The TIFF fixtures in tests/torch_fixtures/ are written by
`write_tiff_fixtures` below (pillow for most, a hand-made writer for the
big-endian multi-strip file); `test_fixtures_match_a_fresh_write` rewrites
them and compares bytes. Regenerate with
`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_native.py`.
"""
import os
import struct
import subprocess
import sys
import unittest.mock as mock
import zlib
from pathlib import Path

import numpy as np
import pytest

from octave_tpu.data import datasets as jds
from octave_tpu.data import native as jnative
from octave_tpu_torch.data import datasets as tds
from octave_tpu_torch.data import native
from octave_tpu_torch.utils.imageio import read_image
from test_torch_imageio import MALFORMED, WRITERS, _luma601, _write_png, _write_png_gray

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
HW = 64
# name -> (pillow mode or "hand", pillow compression, predictor)
TIFF_CASES = {
    "gray_none": ("L", "raw", 1),
    "gray_packbits": ("L", "packbits", 1),
    "gray_lzw": ("L", "tiff_lzw", 1),
    "gray_lzw_pred2": ("L", "tiff_lzw", 2),
    "gray_deflate_pred2": ("L", "tiff_adobe_deflate", 2),
    "gray_deflate32946": ("L", "tiff_adobe_deflate", 1),
    "rgb_lzw_pred2": ("RGB", "tiff_lzw", 2),
    "rgba_deflate": ("RGBA", "tiff_adobe_deflate", 1),
    "gray_bigendian_strips": ("hand", None, 1),
}


# -- the fixture writer -------------------------------------------------------
def _fixture_arrays():
    """Smooth 64x64 images with a little noise: they compress to a few KB."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:HW, 0:HW]
    base = np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 60 + 128
    gray = (base + rng.integers(0, 8, (HW, HW))).astype(np.uint8)
    rgb = np.stack([gray, gray[::-1], gray[:, ::-1]], -1)
    alpha = (rng.integers(0, 2, (HW, HW, 1)) * 255).astype(np.uint8)
    return {"L": gray, "RGB": rgb, "RGBA": np.concatenate([rgb, alpha], -1), "hand": gray.T.copy()}


def tiff_bytes(arr, big=False, rows_per_strip=None):
    """An uncompressed 8-bit grey TIFF in either byte order, in strips."""
    e = ">" if big else "<"
    h, w = arr.shape
    rps = rows_per_strip or h
    strips = [arr[i:i + rps].tobytes() for i in range(0, h, rps)]
    n = len(strips)
    offsets_at = 8
    data_at = offsets_at + 8 * n  # strip offsets, then byte counts, then data
    offsets, pos = [], data_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    ifd_at = pos + (pos & 1)
    # one strip: its offset and byte count sit in the entries themselves
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 8), (259, 3, 1, 1), (262, 3, 1, 1),
               (273, 4, n, offsets[0] if n == 1 else offsets_at), (277, 3, 1, 1),
               (278, 3, 1, rps), (279, 4, n, len(strips[0]) if n == 1 else offsets_at + 4 * n)]
    out = (b"MM\0*" if big else b"II*\0") + struct.pack(e + "I", ifd_at)
    out += struct.pack(e + f"{n}I", *offsets) + struct.pack(e + f"{n}I", *map(len, strips))
    out += b"".join(strips) + b"\0" * (ifd_at - pos)
    out += struct.pack(e + "H", len(entries))
    for tag, typ, count, value in entries:
        field = (struct.pack(e + "H", value) + b"\0\0" if typ == 3 and count == 1
                 else struct.pack(e + "I", value))
        out += struct.pack(e + "HHI", tag, typ, count) + field
    return out + struct.pack(e + "I", 0)


def _set_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with the inline SHORT value of `tag` replaced."""
    buf = bytearray(data)
    ifd = struct.unpack_from("<I", buf, 4)[0]
    for i in range(struct.unpack_from("<H", buf, ifd)[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", buf, e)[0] == tag:
            struct.pack_into("<H", buf, e + 8, value)
            return bytes(buf)
    raise KeyError(tag)


def write_tiff_fixtures(dest: Path) -> None:
    """Write every TIFF of TIFF_CASES and expected.npz (the 601 grey of each)
    into `dest`."""
    from PIL import Image

    dest.mkdir(parents=True, exist_ok=True)
    arrays = _fixture_arrays()
    expected = {}
    for name, (mode, compression, predictor) in TIFF_CASES.items():
        arr = arrays[mode]
        path = dest / f"{name}.tif"
        if mode == "hand":
            path.write_bytes(tiff_bytes(arr, big=True, rows_per_strip=10))
        else:
            kw = {"compression": compression}
            if predictor == 2:
                kw["tiffinfo"] = {317: 2}
            Image.fromarray(arr, mode).save(path, **kw)
            if name == "gray_deflate32946":  # the old Deflate code, same stream
                path.write_bytes(_set_tag(path.read_bytes(), 259, 32946))
        expected[name] = arr if arr.ndim == 2 else _luma601(arr[..., :3])
    np.savez_compressed(dest / "expected.npz", **expected)


# -- fixtures of the tests ----------------------------------------------------
@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail(f"the port's native loader did not build: {native.build_error()}")
    return native


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture()
def gray(rng):
    return rng.integers(0, 256, (37, 53), dtype=np.uint8)


# -- TIFF -------------------------------------------------------------------
def test_fixtures_match_a_fresh_write(tmp_path, expected):
    pytest.importorskip("PIL")
    write_tiff_fixtures(tmp_path)
    for name in TIFF_CASES:
        assert (tmp_path / f"{name}.tif").read_bytes() == (FIXTURES / f"{name}.tif").read_bytes(), name
    with np.load(tmp_path / "expected.npz") as z:
        assert sorted(z.files) == sorted(expected)
        for k in z.files:
            np.testing.assert_array_equal(z[k], expected[k])
    assert all((FIXTURES / f"{n}.tif").stat().st_size < 16_000 for n in TIFF_CASES)


@pytest.mark.parametrize("name", sorted(TIFF_CASES))
def test_tiff_fixture_decodes(lib, expected, name):
    path = str(FIXTURES / f"{name}.tif")
    np.testing.assert_array_equal(lib.decode_image(path), expected[name])
    np.testing.assert_array_equal(tds.load_image_batch([path], (HW, HW))[0], expected[name])


@pytest.mark.parametrize("name", sorted(TIFF_CASES))
def test_tiff_equals_pillow_through_jax(lib, name):
    """The JAX package reads TIFF with pillow (its C++ loader has no TIFF)."""
    pytest.importorskip("PIL")
    path = str(FIXTURES / f"{name}.tif")
    with mock.patch.object(jnative, "available", lambda: False):
        want = jds.load_image_batch([path], (HW, HW))
    np.testing.assert_array_equal(tds.load_image_batch([path], (HW, HW)), want)
    np.testing.assert_array_equal(lib.decode_image(path), want[0])


def test_tiff_batch_with_resize(lib, expected):
    names = sorted(TIFF_CASES)
    paths = [str(FIXTURES / f"{n}.tif") for n in names]
    got = lib.load_batch(paths, (48, 80), n_threads=3)
    rows, cols = (np.arange(48) * HW) // 48, (np.arange(80) * HW) // 80
    for i, n in enumerate(names):
        np.testing.assert_array_equal(got[i], expected[n][rows][:, cols])


def test_tiff_needs_the_native_loader(tmp_path):
    path = str(FIXTURES / "gray_none.tif")
    with mock.patch.object(native, "available", lambda: False):
        with pytest.raises(IOError, match="TIFF needs the native loader"):
            tds.load_image_batch([path], (HW, HW))
        with pytest.raises(IOError, match="TIFF needs the native loader"):
            tds._load_image(path)


def _hostile_tiffs():
    """{case: (bytes of a hostile or unsupported TIFF, the reason it gives)}."""
    good = tiff_bytes(np.arange(64, dtype=np.uint8).reshape(8, 8))
    ifd = struct.unpack_from("<I", good, 4)[0]
    n = struct.unpack_from("<H", good, ifd)[0]

    def patch(typ=None, **values):  # values by tag, e.g. t256=...
        buf = bytearray(good)
        for i in range(n):
            e = ifd + 2 + 12 * i
            tag = struct.unpack_from("<H", buf, e)[0]
            if f"t{tag}" in values:
                if typ is not None:
                    struct.pack_into("<H", buf, e + 2, typ)
                long = struct.unpack_from("<H", buf, e + 2)[0] == 4
                struct.pack_into("<I" if long else "<H", buf, e + 8, values[f"t{tag}"])
        return bytes(buf)

    def add(tag, value):  # one more SHORT entry in the directory, which is last
        entries = good[ifd + 2: ifd + 2 + 12 * n] + struct.pack("<HHIHH", tag, 3, 1, value, 0)
        return good[:ifd] + struct.pack("<H", n + 1) + entries + bytes(4)

    return {
        "truncated_header": (good[:6], "truncated"),
        "directory_past_eof": (good[:4] + struct.pack("<I", 1 << 30) + good[8:], "truncated"),
        "directory_cut": (good[:ifd + 20], "directory"),
        "huge_dims": (patch(t256=65535, t257=65535), "dimensions out of range"),
        "strips_do_not_cover": (patch(t257=65535), "byte counts for 8192 strips"),
        "strip_offset_past_eof": (patch(t273=1 << 30), "past the end"),
        "strip_count_past_eof": (patch(t279=1 << 31), "past the end"),
        "short_strip": (patch(t279=10), "of 10 bytes cannot hold its 64"),
        "sixteen_bit": (patch(t258=16), "16-bit"),
        "white_is_zero": (patch(t262=0), "WhiteIsZero"),
        "palette": (patch(t262=3), "palette"),
        "jpeg": (patch(t259=7), "JPEG"),
        "unknown_compression": (patch(t259=99), "compression 99"),
        "tiled": (add(322, 16), "tiled"),
        "planar": (add(284, 2), "PlanarConfiguration"),
        "float_predictor": (add(317, 3), "predictor 3"),
        "bad_field_type": (patch(typ=11, t256=8), "field type"),
        "corrupt_lzw": (patch(t259=5), "LZW|holds"),
        "corrupt_deflate": (patch(t259=8), "corrupt|holds"),
    }


@pytest.mark.parametrize("case", sorted(_hostile_tiffs()))
def test_hostile_tiff_is_a_failure(lib, tmp_path, case):
    data, reason = _hostile_tiffs()[case]
    p = tmp_path / "bad.tif"
    p.write_bytes(data)
    with pytest.raises(IOError, match=reason):
        lib.decode_image(str(p))
    good = tmp_path / "good.pgm"
    WRITERS["pgm"](str(good), np.zeros((4, 4), np.uint8))
    with pytest.raises(IOError, match="1/2 images failed.*bad.tif"):
        lib.load_batch([str(good), str(p)], (4, 4))


def _headers_larger_than_their_data():
    """{case: a file whose header asks for ~1-2 GB of pixels that its few
    data bytes cannot hold}: a 16384² 16-bit RGBA PNG with a 10-row IDAT,
    and 16384² grey TIFFs of one 64-byte strip under each codec."""
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    side = 1 << 14
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 16, 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(bytes(10 * (side * 8 + 1)))) + chunk(b"IEND", b""))
    good = tiff_bytes(np.arange(64, dtype=np.uint8).reshape(8, 8))
    ifd = struct.unpack_from("<I", good, 4)[0]
    cases = {"png": png}
    for name, compression in (("tiff_none", 1), ("tiff_packbits", 32773), ("tiff_lzw", 5),
                              ("tiff_deflate", 8)):
        buf = bytearray(good)
        for i in range(struct.unpack_from("<H", buf, ifd)[0]):
            e = ifd + 2 + 12 * i
            value = {256: side, 257: side, 278: side, 259: compression}.get(
                struct.unpack_from("<H", buf, e)[0])
            if value is not None:
                struct.pack_into("<H", buf, e + 8, value)
        cases[name] = bytes(buf)
    return cases


@pytest.mark.parametrize("case", sorted(_headers_larger_than_their_data()))
def test_header_larger_than_its_data_is_refused_before_allocation(lib, tmp_path, case):
    """The sizes a header states are checked against the bytes that must
    hold them (Deflate at most 1032-fold, PackBits 64, LZW 4096 per code)
    before the pixel buffer is allocated."""
    p = tmp_path / "big.bin"
    p.write_bytes(_headers_larger_than_their_data()[case])
    with pytest.raises(IOError, match="big.bin.*cannot hold"):
        lib.decode_image(str(p))


@pytest.mark.parametrize("big", [False, True])
def test_byte_orders_and_strips(lib, tmp_path, big):
    arr = np.random.default_rng(1).integers(0, 256, (23, 17), dtype=np.uint8)
    for rps in (1, 5, 23, 100):
        p = tmp_path / f"s{rps}.tif"
        p.write_bytes(tiff_bytes(arr, big=big, rows_per_strip=rps))
        np.testing.assert_array_equal(lib.decode_image(str(p)), arr)


# -- PNG, BMP, PGM against the JAX package's loader and the numpy reader ------
@pytest.mark.parametrize("fmt", ["png", "bmp", "pgm"])
def test_equals_jax_native_single(lib, tmp_path, gray, fmt):
    if not jnative.available():
        pytest.skip(f"the JAX package's loader did not build: {jnative.build_error()}")
    p = str(tmp_path / f"x.{fmt}")
    WRITERS[fmt](p, gray)
    np.testing.assert_array_equal(lib.decode_image(p), jnative.decode_image(p))
    np.testing.assert_array_equal(lib.decode_image(p), gray)
    assert lib.image_size(p) == jnative.image_size(p) == gray.shape


def test_equals_jax_native_batch(lib, tmp_path, rng):
    if not jnative.available():
        pytest.skip(f"the JAX package's loader did not build: {jnative.build_error()}")
    paths = []
    for i, fmt in enumerate(["png", "bmp", "pgm"] * 3):
        p = str(tmp_path / f"b{i}.{fmt}")
        WRITERS[fmt](p, rng.integers(0, 256, (30 + i, 50 - i), dtype=np.uint8))
        paths.append(p)
    for size in ((30, 50), (16, 16), (45, 70)):
        got = lib.load_batch(paths, size, n_threads=4)
        np.testing.assert_array_equal(got, jnative.load_batch(paths, size, n_threads=4))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, 5])
def test_row_filters_equal_read_image(lib, tmp_path, gray, ftype):
    p = str(tmp_path / "f.png")
    _write_png_gray(p, gray, ftype)
    np.testing.assert_array_equal(lib.decode_image(p), read_image(p))
    np.testing.assert_array_equal(lib.decode_image(p), gray)


def test_colour_png_is_601_luma(lib, tmp_path, rng):
    """ROADMAP C.3 stays out of the port: colour PNG is the 601 luma."""
    rgb = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    _write_png(p, rgb.reshape(19, -1), 23, 19, 8, 2, 3, ftype=5)
    np.testing.assert_array_equal(lib.decode_image(p), _luma601(rgb))
    np.testing.assert_array_equal(lib.decode_image(p), read_image(p))


def test_png_variants_equal_read_image(lib, tmp_path, rng):
    """RGBA, grey + alpha, palette, 16-bit grey and RGB, sub-byte grey and
    palette, each with a different row filter."""
    h, w = 9, 11
    files = []

    def png(name, rows, depth, color, bpp, ftype, palette=None):
        p = str(tmp_path / f"{name}.png")
        _write_png(p, rows, w, h, depth, color, bpp, ftype=ftype, palette=palette)
        files.append(p)

    png("rgba", rng.integers(0, 256, (h, w * 4), dtype=np.uint8), 8, 6, 4, 4)
    png("ga", rng.integers(0, 256, (h, w * 2), dtype=np.uint8), 8, 4, 2, 3)
    png("g16", rng.integers(0, 256, (h, w * 2), dtype=np.uint8), 16, 0, 2, 1)
    png("rgb16", rng.integers(0, 256, (h, w * 6), dtype=np.uint8), 16, 2, 6, 5)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    png("pal", rng.integers(0, 16, (h, w), dtype=np.uint8), 8, 3, 1, 2, palette=pal)
    for depth in (1, 2, 4):
        rows = rng.integers(0, 256, (h, (w * depth + 7) // 8), dtype=np.uint8)
        png(f"g{depth}", rows, depth, 0, 1, 4)
        if depth == 4:
            rows = (rng.integers(0, 16, (h, 6)) * 17).astype(np.uint8)  # indices < 16
            png("pal4", rows, depth, 3, 1, 1, palette=pal)
    for p in files:
        np.testing.assert_array_equal(lib.decode_image(p), read_image(p), err_msg=p)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_hostile_png_bmp_pgm_is_a_failure(lib, tmp_path, gray, case):
    p = str(tmp_path / "bad.bin")
    data = MALFORMED[case]
    if case == "png_truncated":
        _write_png_gray(p, gray)
        data = open(p, "rb").read()[:-40]
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(IOError, match="bad.bin"):
        lib.decode_image(p)


def test_png_stream_of_the_wrong_length(lib, tmp_path):
    """IDAT that inflates to one row too many, or too few, is refused."""
    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    for rows in (3, 5):
        raw = b"".join(b"\0" + bytes(4) for _ in range(rows))
        p = tmp_path / f"r{rows}.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0))
                      + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        with pytest.raises(IOError, match="wrong length"):
            lib.decode_image(str(p))
        with pytest.raises(IOError):
            read_image(str(p))


def test_missing_file_names_it(lib, tmp_path):
    with pytest.raises(IOError, match="nope.png: open failed"):
        lib.decode_image(str(tmp_path / "nope.png"))


# -- the build ----------------------------------------------------------------
def test_six_processes_build_one_library(tmp_path, gray):
    """Six processes find no library and build it at once: each compiles to
    a file of its own and renames it into place, so every one of them loads
    a complete library and one library is left, with no temporary file."""
    img = tmp_path / "x.pgm"
    WRITERS["pgm"](str(img), gray)
    build_dir = tmp_path / "native"
    code = ("import sys; from pathlib import Path; import numpy as np; "
            "from octave_tpu_torch.data import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "assert native.available(), native.build_error(); "
            "print(int(native.decode_image(sys.argv[2]).sum()))")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir), str(img)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    assert {o[0].strip() for o in outs} == {str(int(gray.sum()))}
    left = sorted(f.name for f in build_dir.iterdir())
    assert left == [native.library_path().name], left


if __name__ == "__main__":
    write_tiff_fixtures(FIXTURES)
    print(f"wrote {len(TIFF_CASES)} TIFFs and expected.npz into {FIXTURES}")
