"""Train-state checkpoints, flat state-dict files and the compact weights npz.

The port of `octave_tpu/utils/checkpoint.py`:

  * `CheckpointManager` (:19-58) on `torch.save` instead of orbax. One
    checkpoint is the whole `TrainState`: both modules' `state_dict()`
    (parameters, BN running stats, spectral u/v; a pair of critics under
    `main.` and `c.`), both optimizers' moments and schedule counters, the
    noise generator's state and the step. `save`
    copies the state to host memory before it returns (the next train step
    mutates the parameters in place) and writes the file on a background
    thread; a step's directory gets its final name only when its file is
    complete, so `restore_latest` never reads half a checkpoint. Under a
    process group only rank 0 writes, every rank restores from the same
    directory, and the ranks meet after each save and when closing; the
    state dict is the same with or without data parallelism, so a
    checkpoint of a data-parallel run resumes on one device and back.
  * `save_pytree` / `load_pytree` (:61-76) for a nested dict of tensors,
    e.g. converted pretrained weights.
  * `export_weights_npz` / `load_weights_npz` (:108-188), the compact
    committed-weights format shared with the JAX package: keys `bf16:<path>`
    hold float32 leaves as bfloat16 bit patterns (uint16, round to nearest
    even), keys `raw:<path>` hold other leaves verbatim, and `<path>` is the
    "/"-joined path into the nested dict. A large export is split into
    `<base>-shard{i}-of-{n}.npz`. Both directions need numpy only, and each
    package reads the other's files.
"""
from __future__ import annotations

import glob
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from octave_tpu_torch.parallel import ddp

_BF16_PREFIX = "bf16:"
_RAW_PREFIX = "raw:"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_STATE_FILE = "state.pt"


# -- the train state as one nested dict -----------------------------------
def _optimizer_dict(opt) -> Optional[Dict[str, Any]]:
    if opt is None:
        return None
    return {"opt": opt.opt.state_dict(), "sched": opt.sched.state_dict()}


def state_to_dict(state) -> Dict[str, Any]:
    """Everything of a `train.state.TrainState` that a resumed run needs."""
    return {
        "step": int(state.step),
        "segmentor": state.segmentor.state_dict(),
        "seg_opt": _optimizer_dict(state.seg_opt),
        "critic": state.critic.state_dict() if state.critic is not None else None,
        "critic_opt": _optimizer_dict(state.critic_opt),
        "generator": state.generator.get_state() if state.generator is not None else None,
    }


def load_state_dict_into(state, saved: Dict[str, Any]):
    """Restore `saved` (of `state_to_dict`) into a freshly built TrainState
    of the same configuration, in place. Tensors land on the devices and in
    the layouts the fresh state already has: module tensors are copied into
    the existing ones, the optimizers move their moments to their
    parameters' device in the dtype each was saved in (a bf16 `exp_avg`
    stays bf16), and a schedule takes only its counters (its lambda was
    rebuilt from the config). A step and eval steps captured on the state
    are dropped: the next calls capture anew."""
    for name in ("critic", "critic_opt", "generator"):
        if (saved[name] is None) != (getattr(state, name) is None):
            raise ValueError(f"checkpoint and state disagree on having a {name}")
    if state.graph is not None:  # it reads the tensors the optimizers replace
        state.graph.close()
        state.graph = None
    if state.eval_graphs is not None:  # they read the tensors the restore rewrites
        state.eval_graphs.close()
        state.eval_graphs = None
    state.segmentor.load_state_dict(saved["segmentor"])
    if state.critic is not None:
        state.critic.load_state_dict(saved["critic"])
    for name in ("seg_opt", "critic_opt"):
        opt = getattr(state, name)
        if opt is not None:
            opt.opt.load_state_dict(saved[name]["opt"])
            _keep_saved_dtypes(opt.opt, saved[name]["opt"]["state"])
            opt.sched.load_state_dict(saved[name]["sched"])
    if state.generator is not None:
        state.generator.set_state(saved["generator"].cpu())
    state.step = int(saved["step"])
    return state


def _keep_saved_dtypes(opt: torch.optim.Optimizer, saved_state: Dict[int, Any]) -> None:
    """torch's Optimizer.load_state_dict casts floating state to its
    parameter's dtype: give each state tensor back the dtype it was saved
    in (exact: the cast up was exact)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for index, st in saved_state.items():
        live = opt.state[params[index]]
        for key, value in st.items():
            if torch.is_tensor(value) and live[key].dtype != value.dtype:
                live[key] = live[key].to(value.dtype)


def _to_host(obj: Any) -> Any:
    """A copy of a nested state with every tensor cloned into host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    """Keeps the newest `max_to_keep` checkpoints of a TrainState under
    `directory`, one `step_<n>/state.pt` each."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list:
        """Steps with a complete checkpoint, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Snapshot `state` to host memory now and write it in the
        background (rank 0 only; every rank of a process group calls this,
        and they meet before it returns). Returns False when nothing is
        written: the step is off the save interval or already has a
        checkpoint, or this rank does not write."""
        step = int(step)
        if step % self.save_interval_steps != 0:
            return False
        written = ddp.rank() == 0 and self._save(step, state)
        ddp.barrier()
        return written

    def _save(self, step: int, state: Any) -> bool:
        self.wait()  # one write at a time; also makes the step's presence final
        if os.path.isdir(self._step_path(step)):
            return False
        snapshot = _to_host(state_to_dict(state))
        self._writer = threading.Thread(target=self._write, args=(step, snapshot),
                                        name="octave-checkpoint-writer")
        self._writer.start()
        return True

    def _write(self, step: int, snapshot: Dict[str, Any]) -> None:
        try:
            tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(snapshot, os.path.join(tmp, _STATE_FILE))
            os.rename(tmp, self._step_path(step))  # complete from here on
            if self.max_to_keep:
                for old in self.all_steps()[: -self.max_to_keep]:
                    shutil.rmtree(self._step_path(old), ignore_errors=True)
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def restore_latest(self, state: Any) -> Optional[Any]:
        """Restore the newest complete step into `state` (a freshly built
        TrainState) and return it; None if there is no checkpoint."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(os.path.join(self._step_path(step), _STATE_FILE),
                           map_location="cpu", weights_only=True)
        return load_state_dict_into(state, saved)

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def close(self) -> None:
        """Wait for the write in flight; under a process group every rank
        then finds the checkpoint complete."""
        self.wait()
        ddp.barrier()


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """One-shot synchronous save of a (nested) dict of tensors, e.g.
    converted pretrained weights."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_to_host(tree), path)


def load_pytree(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


# -- the compact committed-weights format ---------------------------------
def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the float32 values they encode (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round to nearest even; a
    NaN becomes the quiet NaN of its sign."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    rounded = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(np.uint16)
    nan = np.where(u >> 31 != 0, np.uint16(0xFFC0), np.uint16(0x7FC0))
    return np.where(np.isnan(a), nan, rounded)


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu().numpy()
        yield prefix, np.asarray(tree)


def _shard_paths(path: str, n: int):
    base = path[:-4] if path.endswith(".npz") else path
    return [f"{base}-shard{i}-of-{n}.npz" for i in range(n)]


def export_weights_npz(path: str, variables: Any, max_bytes: Optional[int] = None) -> None:
    """Save a nested dict of arrays or tensors (a module's `state_dict()`, or
    the JAX package's {"params": ..., "batch_stats": ...}) as a compact npz:
    float32 -> bf16 bit patterns, other dtypes verbatim.

    With `max_bytes`, the leaves are greedily split into shards whose
    uncompressed payload stays under the cap (bf16 weight noise barely
    compresses, so raw bytes bound the file size) and written as
    `<base>-shard{i}-of-{n}.npz`; `load_weights_npz(path)` merges them."""
    out = {}
    for key, arr in _flatten(variables):
        if arr.dtype == np.float32:
            out[_BF16_PREFIX + key] = f32_to_bf16_bits(arr)
        else:
            out[_RAW_PREFIX + key] = arr
    if max_bytes is None:
        np.savez_compressed(path, **out)
        return
    shards, sizes = [{}], [0]
    for key in sorted(out):  # deterministic partition
        nb = out[key].nbytes
        if sizes[-1] and sizes[-1] + nb > max_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = out[key]
        sizes[-1] += nb
    base = path[:-4] if path.endswith(".npz") else path
    for stale in glob.glob(f"{base}-shard*-of-*.npz"):
        os.remove(stale)
    for p, shard in zip(_shard_paths(path, len(shards)), shards):
        np.savez_compressed(p, **shard)


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
