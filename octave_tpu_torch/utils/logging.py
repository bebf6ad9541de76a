"""Structured metrics logging and per-step timing for `Trainer.fit`.

The port of `octave_tpu/utils/logging.py::MetricsLogger` (a JSONL file, and
W&B and TensorBoard where those packages are installed; a missing one is
skipped silently) and `octave_tpu/utils/profiling.py::StepTimer`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def _summary_writer(log_dir: str):
    """A TensorBoard writer on log_dir: torch's, else tensorboardX's, else
    None when neither package is installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    """One record per `log` call: a JSON line appended to
    <log_dir>/metrics.jsonl, a `wandb.log` with `use_wandb`, a scalar per
    metric to TensorBoard under log_dir with `use_tensorboard`."""

    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 use_tensorboard: bool = False, project: str = "octave-tpu",
                 run_name: Optional[str] = None, config: Optional[Dict[str, Any]] = None):
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project=project, name=run_name, config=config or {})
                self._wandb = wandb
        self._tb = _summary_writer(log_dir) if use_tensorboard and log_dir else None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        record = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        record["step"] = int(step)
        record["time"] = time.time()
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=int(step))
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class StepTimer:
    """Rolling per-step host wall time and throughput."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {"step_time_s": mean, "steps_per_sec": 1.0 / mean,
                "items_per_sec": items_per_step / mean}
