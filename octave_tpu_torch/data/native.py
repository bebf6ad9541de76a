"""ctypes bindings of the port's C++ image loader, compiled at first use.

The counterpart of `octave_tpu/data/native.py`, over the port's own source
(`data/_native/loader.cpp`): PNG, BMP, binary PGM and TIFF decoded to 8-bit
grey, and batches filled by a thread pool with the nearest resize. It reads
every file as `utils/imageio.read_image` does (TIFF, which that reader
lacks, aside).

The library is built with g++ (zlib only) into `build/native/` at the root
of the checkout, never into the package, under a name keyed to a hash of the
source, so a stale library is never loaded. Several processes may build it
at once: each compiles to a file of its own in that directory and renames
it into place, so a reader finds either no library or a complete one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "_native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_ERR_LEN = 1024

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source builds."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liboctave_loader-{digest}.so"


def build() -> Path:
    """Compile the loader into `library_path()` (also when it exists) and
    return that path. Raises RuntimeError with the compiler's output."""
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", str(SOURCE), "-o", str(tmp),
           "-lz", "-pthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native loader: g++ unavailable: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if it cannot build."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.is_file():
                path = build()
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.octave_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(u8p),
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_char_p, ctypes.c_int]
        lib.octave_decode.restype = ctypes.c_int
        lib.octave_free.argtypes = [u8p]
        lib.octave_free.restype = None
        lib.octave_load_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.octave_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable; None if it loaded."""
    get_lib()
    return _build_error


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(_build_error or "native loader unavailable")
    return lib


def decode_image(path: str) -> np.ndarray:
    """Decode one file to (h, w) uint8 grey. Raises IOError naming the file
    and the loader's reason."""
    lib = _need_lib()
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.octave_decode(os.fsencode(path), ctypes.byref(ptr), ctypes.byref(w), ctypes.byref(h),
                         err, _ERR_LEN) != 0:
        raise IOError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        return np.ctypeslib.as_array(ptr, shape=(h.value, w.value)).copy()
    finally:
        lib.octave_free(ptr)


def image_size(path: str) -> Tuple[int, int]:
    """(h, w) of an image file."""
    return decode_image(path).shape


def load_batch(paths: Sequence[str], size, n_threads: Optional[int] = None) -> np.ndarray:
    """Decode and nearest-resize files into (n, h, w) uint8 on the loader's
    thread pool. Raises IOError if any file fails, naming the first."""
    lib = _need_lib()
    paths: List[str] = [os.fspath(p) for p in paths]
    h, w = (int(s) for s in size)
    if h <= 0 or w <= 0:
        raise ValueError(f"load_batch: size must be positive, got {size}")
    if any("\n" in p for p in paths):
        raise ValueError("load_batch: a path holds a newline")
    out = np.empty((len(paths), h, w), np.uint8)
    if not paths:
        return out
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    err = ctypes.create_string_buffer(_ERR_LEN)
    failures = lib.octave_load_batch(
        b"\n".join(os.fsencode(p) for p in paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, int(n_threads), err, _ERR_LEN)
    if failures:
        raise IOError(f"{failures}/{len(paths)} images failed to decode; first "
                      f"{err.value.decode(errors='replace')}")
    return out
