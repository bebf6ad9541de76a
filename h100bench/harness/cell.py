"""A cell as files: its entry in BENCHMARK.json, its workload file, its
configuration file, its traffic driver and its per-layer readers, all found by
name, and the state of one run of it."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(path: str, name: str) -> ModuleType:
    """The Python file at `path` as a module (file names may hold dots)."""
    if not os.path.isfile(path):
        raise OSError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    """What BENCHMARK.json and the cell's files say about one cell."""

    name: str
    chips: int
    workload: Dict[str, Any]  # h100bench/workloads/<name>.json
    config: Dict[str, Any]  # h100bench/configs/<config>.json
    driver: ModuleType  # h100bench/drivers/<driver>.py
    end_to_end: List[Dict[str, Any]]  # BENCHMARK.json entries this cell reports
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, ModuleType]  # per-layer metric name -> its reader
    bench_dir: str


def _applies(metric: Dict[str, Any], cell: str, e2e_names: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(root: str, name: str, bench_dir: str = BENCH_DIR) -> Spec:
    """The cell `name` of `root`/BENCHMARK.json, its files read from
    `bench_dir`."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    spec = from_files(name, int(entry["chips"]), e2e, per_layer, bench_dir)
    if spec.workload["config"] != entry["config"]:
        raise ValueError(f"cell {name}: BENCHMARK.json names configuration {entry['config']!r}, "
                         f"its workload file {spec.workload['config']!r}")
    return spec


def from_files(name: str, chips: int, end_to_end: List[Dict[str, Any]],
               per_layer: List[Dict[str, Any]], bench_dir: str = BENCH_DIR) -> Spec:
    """The cell `name` from its files alone, reporting the metrics given."""
    workload = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = _json(os.path.join(bench_dir, "configs", f"{workload['config']}.json"))
    driver = _module(os.path.join(bench_dir, "drivers", f"{workload['driver']}.py"),
                     f"h100bench_driver_{workload['driver']}")
    readers = {m["name"]: _module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                                  f"h100bench_metric_{m['name'].replace('.', '_')}")
               for m in per_layer}
    return Spec(name, chips, workload, config, driver, list(end_to_end), list(per_layer),
                readers, bench_dir)


@dataclasses.dataclass
class Check:
    """One number compared for `correct`, with its limit (value <= limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Result:
    """What a driver hands back: the end-to-end values it measured, the
    work attempted and failed in the window, the comparisons, the device
    peak and, in a traced run, the reading for the per-layer metrics."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    reading: Optional[Any] = None  # harness.trace.Reading, traced runs only
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)  # all numbers compared

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


class Run:
    """One run's arguments, clock and counters."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 process_start: float, device: str = "cuda"):
        self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
        self.process_start = process_start
        self.device = device  # "cpu" only where a test rehearses a driver
        self.setup_s: Optional[float] = None

    @property
    def workload(self) -> Dict[str, Any]:
        return self.spec.workload

    @property
    def config(self) -> Dict[str, Any]:
        return self.spec.config

    def setup_done(self) -> float:
        """Close set-up: the first timed unit of work starts now."""
        now = time.perf_counter()
        self.setup_s = now - self.process_start
        return now
