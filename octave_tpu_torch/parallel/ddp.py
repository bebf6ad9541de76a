"""Data parallelism over several processes, one device each.

The counterpart of `octave_tpu/parallel/mesh.py`, on `torch.distributed`.
The JAX package shards the batch over a 1-D device mesh inside one program
and `pmean`s gradients, losses and batch-norm statistics across it; here
every rank is a process that holds a full replica of the model, takes its
rows of the global batch (`shard_rows`), and meets the other ranks in
`all_reduce`, the only collective this module uses (no all-gather, no
broadcast of activations), so gloo serves CPU and CUDA tensors alike and
NCCL serves CUDA tensors:

  * batch-norm statistics and their backward sums, the WPCE class counts:
    `all_reduce_sum` (`ops/norm.py`, `losses/segmentor.py`);
  * gradients: `all_reduce_mean_` between backward and the optimizer step,
    so a clip sees the mean gradient, as optax does after `pmean`;
  * losses for logging, eval counts, the stop flag: plain sums and maxima.

`init_distributed` joins a process group; `launch` spawns n worker
processes on one host and joins each to a group.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Join the default process group. `backend` defaults to NCCL when CUDA
    is available and to gloo otherwise; with no `init_method`, rank and world
    size come from the environment torchrun sets (env://)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(backend, **kw)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """The rank among this host's processes (torchrun's LOCAL_RANK), which
    picks the device: cuda:{local_rank}."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def shard_rows(global_batch: int, rank: int, world: int) -> slice:
    """Rows [r*B/n, (r+1)*B/n) of a global batch of B: equal shards, as the
    JAX mesh requires, so n must divide B."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"shard_rows: rank {rank} outside a world of {world}")
    if global_batch % world:
        raise ValueError(f"shard_rows: {world} ranks do not divide a global batch of "
                         f"{global_batch} into equal shards")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over ranks (a new tensor); `x` itself without a process
    group. Not differentiable: batch norm's backward all-reduces its own
    sums (`ops/norm.py`)."""
    if not is_distributed():
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Element-wise maximum over ranks (a new tensor)."""
    out = x.clone()
    if is_distributed():
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def all_reduce_mean_(tensors: Iterable[Optional[torch.Tensor]]) -> None:
    """Replace each tensor by its mean over ranks, in place: one flattened
    all-reduce per (device, dtype) bucket. None entries (parameters without
    a gradient) are skipped."""
    n = world()
    if n == 1:
        return
    buckets = {}
    for t in tensors:
        if t is not None:
            buckets.setdefault((t.device, t.dtype), []).append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for t in group:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def _worker(rank_: int, fn: Callable, world_size: int, backend: str, init_method: str,
            devices: Sequence[str], args: tuple, results) -> None:
    try:
        device = torch.device(devices[rank_])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(backend, init_method, rank_, world_size)
        try:
            out = fn(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank_, False, traceback.format_exc()))


def launch(fn: Callable[..., Any], n: int, backend: str, devices: Sequence[str],
           args: tuple = (), timeout: Optional[float] = 600.0,
           init_method: Optional[str] = None) -> List[Any]:
    """Run fn(device, *args) in n spawned processes, rank r on devices[r],
    each joined to a fresh process group of n (a file store in a temporary
    directory unless `init_method` names one). Returns the n results in rank
    order; raises if a worker fails or the n do not finish within `timeout`
    seconds (None: no limit), after ending every worker. `fn`, its
    arguments and its result must pickle."""
    if len(devices) != n:
        raise ValueError(f"launch: {n} workers but {len(devices)} devices")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="octave_ddp_") as tmp:
        init = init_method or "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, fn, n, backend, init, list(devices), args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        try:
            # read the results before joining: a worker whose result is
            # still in the queue's pipe does not exit
            deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
            while len(got) < n:
                try:
                    r, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"launch: a worker exited with code {dead[0]} "
                                           "before reporting")
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"launch: {n - len(got)} of {n} workers did not "
                                           f"finish in {timeout:.0f} s")
                    continue
                if not ok:  # the others may wait for it in a collective
                    raise RuntimeError(f"launch: rank {r} failed\n{out}")
                got[r] = out
            for p in procs:
                p.join(timeout=min(60.0, max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n)]
