"""The upper readings the limits of the dual-decoder training cells are set
from, on the card.

    python3 h100bench/control_dual.py --workload train-phg-b8 --seeds 1,2,3
    python3 h100bench/control_dual.py --workload train-phg-b8 --seeds 1,2,3 --controls fp8

For each seed it puts the reference (`reference.dual`) in the program's
place at the cell's own size and prints the numbers compared for each
control: every conv and matmul operand in float8 e4m3 (the step below
bfloat16), half of each batch, the `_c` head's supervised term dropped, the
`_c` pyramid's ILD dropped, and the "c" critic never updated; `--controls`
takes a subset. The lower readings, the program's own over many seeds, come
from `control.py --program`, which runs any cell's driver. Each line is one
JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

CONTROLS = {"fp8": {"precision": "fp8"}, "half_batch": {"half_batch": True},
            "no_sup_c": {"fault": "no_sup_c"}, "no_ild_c": {"fault": "no_ild_c"},
            "frozen_critic_c": {"fault": "frozen_critic_c"}}


def training_controls(run, names=tuple(CONTROLS)) -> dict:
    from harness import training_dual

    conf = run.spec.driver.program_config(run)
    ref = training_dual.reference_run(run, conf)
    return {name: training_dual.readings(
        *training_dual.reference_run(run, conf, **CONTROLS[name]), *ref) for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    args = ap.parse_args(argv)
    from harness import cell

    spec = cell.load(ROOT, args.workload)
    names = tuple(args.controls.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.Run(spec, seed, 0.0, False, time.perf_counter())
        print(json.dumps({"seed": seed, "kind": "control", **training_controls(run, names)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
