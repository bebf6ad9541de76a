"""Benchmark of `octave_tpu_torch` on NVIDIA GPUs: one cell, one run.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `h100bench/workloads/<cell>.json`; it names its configuration
(`h100bench/configs/<config>.json`) and its traffic driver
(`h100bench/drivers/<driver>.py`). The metrics a cell reports are the ones
`BENCHMARK.json` (at the root of the checkout) assigns to it: with
`--trace 0` its end-to-end metrics, with `--trace 1` its per-layer metrics,
each read by `h100bench/metrics/<metric>.py` from the traced stretch. The last
line of standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, and with `--trace 1` `breakdown`); the numbers that
decided `correct`, each beside its limit, are the last lines of standard
error and the last key of that object.

The run exits non-zero without a result when there is no CUDA device, fewer
than the cell asks for, or when JAX or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from harness import cell, report

    try:
        spec = cell.load(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"h100bench: the cell needs {spec.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = cell.Run(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   process_start=PROCESS_START)
    result = spec.driver.run(run)
    loaded = report.forbidden_modules(sys.modules)
    if loaded:
        print(f"h100bench: modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 4
    line = report.result_line(spec, run, result)
    report.print_checks(result.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
