"""The readings the limits of `correct` are set from, on the card.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 --program --seconds 3
    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 --control

`--program` runs the cell's driver once per seed in this one process (the
kernels build once) and prints the numbers compared: the lower readings.
`--control` puts the reference in the program's place at the cell's own
size, computed one precision lower than the configuration states, and plants
the faults the cell can have, and prints the same numbers: the upper
readings. Serving: the decoder's convs in int4 (the step below its int8), the
program's own int8-everywhere path (`int8_scope` "all"; through the driver
at the cell's size: `--program --set 'int8_scope="all"'`), and an answer
altered where it is produced (one image's output replaced by another's).
Training: the reference with every conv and matmul operand in float8 e4m3
(the step below bfloat16), run on half of each batch, without the ILD term,
without the adversarial term, and with its critic never updated; a state
left unchanged reads about 1 on the changes by construction. `--set`
overrides a configuration key (dotted=JSON) for a witness run, such as the
program in float32. Each line is one JSON object.
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


def serving_controls(run) -> dict:
    import numpy as np

    from harness import device, serving
    from reference.phantoms import as_rgb

    wl, cfg = run.workload, run.config
    n = wl["sample_dispatches"] * wl["rows_per_dispatch"]
    served = serving.seeded_weights(run, cfg["calibration_images"] + n)
    images = served.images[cfg["calibration_images"]:]
    ref = serving.reference_outputs(served.params, images)
    yard = serving.reference_outputs(served.params, images, precision=cfg["yardstick"])
    out = {"int4_decoder": serving.served_gaps(
        serving.reference_outputs(served.params, images, precision="int4_decoder"), ref, yard)}
    altered = ref.copy()
    altered[-1] = ref[0]
    out["answer_altered"] = serving.served_gaps(altered, ref, yard)
    pred = serving.predictor(run, served, "all")
    got = np.asarray(pred(as_rgb(images).cpu().numpy()))
    out["program_int8_all"] = serving.served_gaps(got, ref, yard)
    del pred
    device.release(run.device)
    return out


def training_controls(run) -> dict:
    from harness import training

    conf = run.spec.driver.program_config(run)
    ref = training.reference_run(run, conf)
    out = {}
    for name, kw in (("fp8", {"precision": "fp8"}), ("half_batch", {"half_batch": True}),
                     ("no_ild", {"fault": "no_ild"}), ("no_adv", {"fault": "no_adv"}),
                     ("frozen_critic", {"fault": "frozen_critic"})):
        got = training.reference_run(run, conf, **kw)
        out[name] = training.readings(*got, *ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="a configuration override, dotted=JSON (a witness run)")
    args = ap.parse_args(argv)
    from harness import cell

    spec = cell.load(ROOT, args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        *path, last = key.split(".")
        node = spec.config
        for part in path:
            node = node[part]
        node[last] = json.loads(value)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cell.Run(spec, seed, args.seconds, False, time.perf_counter())
        if args.program:
            res = spec.driver.run(run)
            print(json.dumps({"seed": seed, "kind": "program", "correct": res.correct,
                              "metrics": res.metrics, "readings": res.readings}), flush=True)
        if args.control:
            controls = (training_controls(run) if spec.workload["driver"] == "fit"
                        else serving_controls(run))
            print(json.dumps({"seed": seed, "kind": "control", **controls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
