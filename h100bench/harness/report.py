"""The run's result line and its checks."""
from __future__ import annotations

import sys
from typing import Dict, List

# top-level module names that no run may hold once its window has closed:
# JAX and the package this port was made from (compared whole: the port's
# own name, `octave_tpu_torch`, only begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "octave_tpu")


def forbidden_modules(modules) -> List[str]:
    """The loaded top-level names among FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def result_line(spec, run, result) -> Dict:
    """The JSON object of the run's last line of standard output."""
    import torch

    metrics: Dict[str, Dict] = {}
    if run.trace:
        for m in spec.per_layer:
            value = spec.readers[m["name"]].read(result.reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" else result.metrics.get(m["name"])
            if value is None:
                raise RuntimeError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec.chips,
              "memory_peak_bytes": int(result.memory_peak_bytes)}
    line = {"correct": result.correct, "attempted": int(result.attempted),
            "failed": int(result.failed), "metrics": metrics, "device": device}
    if run.trace and result.reading is not None:
        device["busy_s"] = result.reading.busy_s
        device["window_s"] = result.reading.window_s
        line["breakdown"] = result.reading.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in result.checks}
    return line


def print_checks(checks) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
