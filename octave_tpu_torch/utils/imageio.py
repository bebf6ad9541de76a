"""Dependency-free grayscale image IO: numpy, zlib and struct only.

The port of `octave_tpu/utils/imageio.py::write_png_gray` (:15-35) and, for
the read side, of what `octave_tpu/data/_native/loader.cpp` decodes:

  * PNG (loader.cpp:42-114): gray, gray+alpha, RGB, RGBA and palette, 1 to
    16 bits, non-interlaced; alpha is dropped, 16-bit samples keep their high
    byte, sub-byte gray is scaled to 0..255;
  * BMP (:122-196): uncompressed 8-bit palette (read through the palette's
    blue channel), 24 and 32 bit, bottom-up or top-down rows;
  * binary PGM `P5` with maxval <= 255 (:199-222).

`read_image` sniffs the format from the file's first bytes, never from its
name, and returns (h, w) uint8. Colour becomes grey by the ITU-R 601 luma
(299 R + 587 G + 114 B) // 1000, as `load_image_batch` documents for every
format. The port's C++ loader (`data/native.py`) reads every file as this
reader does, byte for byte, and also reads TIFF, which this reader refuses.
The JAX package's C++ loader differs for colour PNG only: it leaves the
weights to libpng's default (Rec. 709: 0.2127 R + 0.7152 G + 0.0722 B), up
to 33 grey levels apart; grayscale files, which the OCTA datasets ship, read
identically.
Headers are untrusted: dimensions are capped before anything is allocated and
every region is checked against the file's size; any malformed file raises
IOError.
"""
from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_MAX_DIM = 1 << 16  # pixels per side
_MAX_PIXELS = 1 << 28
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def write_png_gray(path: str, arr: np.ndarray) -> None:
    """Write (h, w) uint8 (or float in [0,1]) as an 8-bit grayscale PNG."""
    if np.issubdtype(arr.dtype, np.floating):
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim != 2 or arr.dtype != np.uint8:
        raise ValueError(f"expected (h, w) uint8, got {arr.shape} {arr.dtype}")
    h, w = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1).tobytes()  # filter 0 rows

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _check_dims(w: int, h: int, what: str) -> None:
    if not (0 < w <= _MAX_DIM and 0 < h <= _MAX_DIM and w * h <= _MAX_PIXELS):
        raise IOError(f"{what} dimensions out of range: {w}x{h}")


def _luma(rgb: np.ndarray) -> np.ndarray:
    """(..., >=3) uint8 RGB -> uint8 grey, ITU-R 601 in integer arithmetic."""
    c = rgb.astype(np.uint32)
    return ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8)


def _unfilter(data: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: (h, rowbytes) uint8 of raw samples. `bpp` is
    the filter's byte distance to the pixel on the left."""
    src = np.frombuffer(data, np.uint8).reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        ftype, line = int(src[y, 0]), src[y, 1:]
        if ftype == 0:
            row = line
        elif ftype == 2:  # Up
            row = line + prev
        elif ftype == 1:
            # Sub: a running sum modulo 256 along each byte lane (rowbytes is
            # a multiple of bpp: whole bytes per pixel, or bpp = 1)
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype in (3, 4):
            # Average, Paeth: each byte depends on the one just decoded
            cur, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise IOError(f"png: unknown row filter {ftype}")
        out[y] = row
        prev = out[y]
    return out


def _decode_png(buf: bytes) -> np.ndarray:
    pos, ihdr, palette, idat = len(_PNG_SIG), None, None, []
    while pos + 8 <= len(buf):
        (length,), tag = struct.unpack(">I", buf[pos:pos + 4]), buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise IOError("png truncated inside a chunk")
        pos += 12 + length  # length, tag, body, crc
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise IOError("png without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    _check_dims(w, h, "png")
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise IOError(f"png: unsupported colour type {color} at {depth} bits")
    if interlace:
        raise IOError("png: interlaced files are not supported")
    channels = _PNG_CHANNELS[color]
    bits = channels * depth
    rowbytes = (w * bits + 7) // 8
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"png: corrupt pixel data ({e})")
    if len(data) != h * (rowbytes + 1):
        raise IOError("png: pixel data has the wrong length")
    rows = _unfilter(data, h, rowbytes, max(1, bits // 8))
    if depth == 16:
        samples = rows.reshape(h, w * channels, 2)[..., 0]  # the high byte
    elif depth == 8:
        samples = rows
    else:
        per_byte = 8 // depth
        bitsarr = np.unpackbits(rows, axis=1).reshape(h, rowbytes * per_byte, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bitsarr * weights).sum(-1).astype(np.uint8)[:, :w]
        if color == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    samples = samples.reshape(h, w, channels)
    if color == 3:
        if palette is None or int(samples.max()) >= len(palette):
            raise IOError("png: palette missing or too short")
        return _luma(palette[samples[..., 0]])
    if color in (2, 6):
        return _luma(samples)
    return np.ascontiguousarray(samples[..., 0])  # gray; alpha dropped


def _decode_bmp(buf: bytes) -> np.ndarray:
    size = len(buf)
    if size < 54:
        raise IOError("bmp read failed")
    data_off, hdr_size, w, h = struct.unpack("<IIii", buf[10:26])
    bpp, comp = struct.unpack("<HI", buf[28:34])
    topdown = h < 0
    h = abs(h)
    if comp != 0 or bpp not in (8, 24, 32) or hdr_size < 40:
        raise IOError("unsupported bmp variant")
    _check_dims(w, h, "bmp")
    stride = ((w * bpp + 31) // 32) * 4
    if data_off > size or data_off + stride * h > size:
        raise IOError("bmp truncated")
    # an 8-bit row may hold any of 256 indices, so the whole palette must fit
    if bpp == 8 and 14 + hdr_size + 256 * 4 > size:
        raise IOError("bmp palette truncated")
    rows = np.frombuffer(buf, np.uint8, stride * h, data_off).reshape(h, stride)
    if not topdown:
        rows = rows[::-1]
    if bpp == 8:
        palette = np.frombuffer(buf, np.uint8, 256 * 4, 14 + hdr_size).reshape(256, 4)
        return np.ascontiguousarray(palette[:, 0][rows[:, :w]])
    px = rows[:, : w * (bpp // 8)].reshape(h, w, bpp // 8)
    return _luma(px[..., 2::-1])  # stored as BGR


def _decode_pgm(buf: bytes) -> np.ndarray:
    m = re.match(rb"P5\s*(-?\d+)\s+(-?\d+)\s+(-?\d+)", buf)
    if m is None:
        raise IOError("unsupported pgm")
    w, h, maxv = (int(g) for g in m.groups())
    if maxv > 255 or maxv < 1:
        raise IOError("unsupported pgm")
    _check_dims(w, h, "pgm")
    start = m.end() + 1  # one whitespace byte after maxval
    if len(buf) < start + w * h:
        raise IOError("pgm truncated")
    return np.frombuffer(buf, np.uint8, w * h, start).reshape(h, w).copy()


def read_image(path: str) -> np.ndarray:
    """Decode a PNG, BMP or binary PGM file to (h, w) uint8 grayscale. The
    format is taken from the file's first bytes. Raises IOError for a missing,
    truncated, malformed or unsupported file, a TIFF among them."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        if buf.startswith(_PNG_SIG):
            return _decode_png(buf)
        if buf[:2] == b"BM":
            return _decode_bmp(buf)
        if buf[:2] == b"P5":
            return _decode_pgm(buf)
        if buf[:4] in (b"II*\0", b"MM\0*"):
            raise IOError("TIFF needs the native loader (octave_tpu_torch.data.native)")
    except (struct.error, ValueError, IndexError) as e:
        raise IOError(f"{path}: malformed image ({e})")
    except IOError as e:
        raise IOError(f"{path}: {e}")
    raise IOError(f"{path}: unknown image format")
