"""Reader for the compact committed-weights npz format.

The format is written by the JAX package (octave_tpu/utils/checkpoint.py,
`export_weights_npz`): keys `bf16:<path>` hold float32 leaves as bfloat16
bit patterns (uint16), keys `raw:<path>` hold other leaves verbatim, and
`<path>` is the "/"-joined path into {"params": ..., "batch_stats": ...}.
A large export is split into `<base>-shard{i}-of-{n}.npz`. This reader needs
numpy only: it widens bf16 bit patterns to float32 itself.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict

import numpy as np

_BF16_PREFIX = "bf16:"
_RAW_PREFIX = "raw:"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the float32 values they encode (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _shard_paths(path: str, n: int):
    base = path[:-4] if path.endswith(".npz") else path
    return [f"{base}-shard{i}-of-{n}.npz" for i in range(n)]


def load_weights_npz(path: str) -> Dict[str, Any]:
    """Nested dict of float32 (and raw) numpy leaves from a single npz or
    from the logical path of a sharded export."""
    if os.path.exists(path):
        files = [path]
    else:
        base = path[:-4] if path.endswith(".npz") else path
        files = sorted(glob.glob(f"{base}-shard*-of-*.npz"))
        if not files:
            raise FileNotFoundError(path)
        expect = _shard_paths(path, int(files[0].rsplit("-of-", 1)[1][:-4]))
        if files != expect:
            raise FileNotFoundError(
                f"incomplete shard set for {path}: found {files}, expected {expect}")
    tree: Dict[str, Any] = {}
    for f in files:
        with np.load(f) as data:
            for full in data.files:
                if full.startswith(_BF16_PREFIX):
                    key, arr = full[len(_BF16_PREFIX):], bf16_bits_to_f32(data[full])
                elif full.startswith(_RAW_PREFIX):
                    key, arr = full[len(_RAW_PREFIX):], data[full]
                else:
                    raise ValueError(f"unknown npz key prefix: {full!r}")
                node = tree
                parts = key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = arr
    return tree
