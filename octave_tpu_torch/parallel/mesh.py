"""Device meshes for serving: the port of `octave_tpu/parallel/mesh.py`
(`make_mesh`, `shard_batch`, `replicate`, :39-71).

The JAX package's 1-D data mesh is a `jax.sharding.Mesh`; here it is a tuple
of `torch.device`s, one per replica, and the "data" axis is the position in
that tuple. One program drives every device of the mesh (the `Predictor`'s
fan-out, `serve.py`): each device holds a full replica of the model and
takes its rows of the batch. Training over several devices runs one process
per device instead (`parallel/ddp.py`).

A mesh may name one device more than once, e.g. `(cpu, cpu)` or
`(cuda:0, cuda:0)`: the counterpart of JAX's virtual CPU devices, which is
how the fan-out runs on a host with one device.
"""
from __future__ import annotations

import copy
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The first `n_devices` (default: every) visible CUDA device."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {visible} available on platform "
            "'cuda'; a mesh may name one device more than once, e.g. "
            "(torch.device('cuda', 0),) * 2, or (torch.device('cpu'),) * 2 on a host "
            "without CUDA")
    return tuple(torch.device("cuda", i) for i in range(n))


def as_mesh(mesh: Iterable) -> Mesh:
    """A mesh as a tuple of `torch.device`: at least one, all of one type,
    CUDA ones with an index (cuda -> cuda:<current device>)."""
    devices = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d} requested but CUDA is not available")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        devices.append(d)
    if not devices or len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh is one or more devices of one type; got {devices}")
    return tuple(devices)


def split_rows(x, n: int, axis_pos: int = 0) -> List:
    """`x` (a tensor or an array) cut into `n` equal slices along `axis_pos`;
    raises ValueError unless n divides that axis, as JAX's NamedSharding
    refuses an uneven batch."""
    size = x.shape[axis_pos]
    if size % n:
        raise ValueError(f"a batch axis of {size} rows does not divide over a mesh of "
                         f"{n} devices")
    rows = size // n
    index = [slice(None)] * axis_pos
    return [x[tuple(index + [slice(i * rows, (i + 1) * rows)])] for i in range(n)]


def shard_batch(x, mesh: Sequence[torch.device], axis_pos: int = 0) -> List[torch.Tensor]:
    """A host batch (tensor or array) split evenly along `axis_pos` (1 for a
    (k, B, ...) stack), shard i copied to mesh[i]."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    mesh = as_mesh(mesh)
    return [piece.to(d, non_blocking=True)
            for piece, d in zip(split_rows(x, len(mesh), axis_pos), mesh)]


def replicate(module: nn.Module, mesh: Sequence[torch.device]) -> List[nn.Module]:
    """One deep copy of `module` per device of the mesh, on that device
    (parameters and buffers alike)."""
    return [copy.deepcopy(module).to(d) for d in as_mesh(mesh)]
