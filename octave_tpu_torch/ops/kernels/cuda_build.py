"""Build and load the port's CUDA C++ kernels (`csrc/*.cu`, `csrc/*.cuh`).

nvcc compiles every source under `csrc/` for `sm_90a` (Hopper), one nvcc
per source, all started together, and links the objects into one shared
library with a plain C interface, at first use, into `build/cuda/` at the
root of the checkout (listed in .gitignore), never into the package. The
library's name carries a hash of the sources, headers and flags, so a stale
build is never loaded. Several processes may build at once: each compiles
to files of its own and renames the library into place, so a reader finds
either no library or a complete one (as `data/native.py` does for the
loader).

A failed build raises with nvcc's output; nothing falls back. The library
is loaded with ctypes: each entry point gets `argtypes` there (`c_void_p`
for every pointer and the stream, `c_int` for every integer, a pointer to a
`c_int` for an out-parameter).

    lib = cuda_build.load()        # builds if needed
    lib.octave_int8_conv(...)      # see ops/kernels/int8_conv.py
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from octave_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no multiply-add contraction anywhere, so the kernels'
# float32 arithmetic rounds where the plain PyTorch versions round;
# -Xptxas -v: registers, shared memory and spills of each kernel, kept in
# `build_log`
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

# c_void_p for each pointer and the stream, c_int for each integer (and a
# pointer to one for an out-parameter)
_I, _P = ctypes.c_int, ctypes.c_void_p
ARGTYPES = {
    "octave_int8_conv": [_P, _P, _P, _P, _I, _I, _I, _I,   # source a
                         _P, _P, _P, _P, _I, _I, _I, _I,   # source b
                         _I, _P, _I, _P, _I, _I,           # nsrc, bias, bias_f32, out, dtype, vec
                         _I, _I, _I, _I, _I,               # b, h, w, ho, wo
                         _I, _I, _I, _I, _I, _I, _I, _I,   # kh, kw, sh, sw, ph, pw, dh, dw
                         _I, _I, _I, _I, _P,               # n, cout, transpose, store2, stream
                         _I, ctypes.POINTER(_I)],          # force, path taken (out)
    "octave_int8_conv_init": [],  # once per device, outside any capture
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output of the last build in this process


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default place."""
    for d in os.environ.get("PATH", "").split(os.pathsep):
        cand = Path(d) / "nvcc"
        if cand.is_file():
            return str(cand)
    return NVCC_DEFAULT


def compile_command(source: Path, output: Path) -> List[str]:
    return [nvcc(), *ARCH, *FLAGS, "-c", str(source), "-o", str(output)]


def link_command(objects: List[Path], output: Path) -> List[str]:
    return [nvcc(), *ARCH, "-shared", "-o", str(output), *map(str, objects)]


def library_path() -> Path:
    """Where the library of these sources, headers and flags builds."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liboctave_kernels-{h.hexdigest()[:16]}.so"


def _stop(procs) -> None:
    for q in procs:
        q.kill()
        q.wait()


def _run(cmds: List[List[str]]) -> str:
    """Run the commands at once; their output, or RuntimeError with it."""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
    except OSError as e:
        raise RuntimeError(f"CUDA kernels: nvcc did not run ({' '.join(cmds[0])}): {e}") from e
    outs = []
    for cmd, proc in zip(cmds, procs):
        try:
            out = proc.communicate(timeout=900)[0]
        except subprocess.TimeoutExpired as e:
            _stop(procs)
            raise RuntimeError(f"CUDA kernels: nvcc timed out ({' '.join(cmd)})") from e
        if proc.returncode != 0:
            _stop(procs)
            raise RuntimeError(f"CUDA kernels: build failed ({' '.join(cmd)}):\n{out}")
        outs.append(out)
    return "".join(outs)


def build() -> Path:
    """Compile the sources into `library_path()` (also when it exists) and
    return that path, as the phase `octave.kernels.build`
    (`utils.profiling`). Raises RuntimeError with nvcc's output."""
    with profiling.phase("octave.kernels.build"):
        return _build()


def _build() -> Path:
    global build_log
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = target.with_name(f"{target.stem}.{tag}.tmp.so")
    try:
        log = _run([compile_command(s, o) for s, o in zip(sources(), objects)])
        log += _run([link_command(objects, tmp)])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
    os.replace(tmp, target)
    build_log = log
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.octave_cuda_error.argtypes = [ctypes.c_int]
            lib.octave_cuda_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib
