"""The benchmark's tests: the harness's folder and the repository root on the
path, and the rehearsal of a cell on the CPU at a tiny size."""
import copy
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes of the cells' files for a CPU rehearsal
TINY_SERVE = {"image_size": 64, "calibration_images": 8, "bn_statistics_images": 8}
TINY_TRAIN = {"program_config": {"data": {"image_size": [64, 64], "batch_size": 4,
                                          "synthetic_n": 8}},
              "image_size": 64}


def merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            merge(a[k], v)
        else:
            a[k] = v
    return a


@pytest.fixture
def rehearse():
    """rehearse(cell, config_overrides, workload_overrides, seed, seconds) ->
    (Run, Result) of the cell's driver on the CPU."""
    import torch

    from harness import cell

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))

    def go(name, cfg=None, wl=None, seed=2 ** 31 + 11, seconds=1.0, trace=False):
        spec = cell.from_files(name, 1, [], [])
        spec.config = merge(copy.deepcopy(spec.config), cfg or {})
        spec.workload = merge(copy.deepcopy(spec.workload), wl or {})
        run = cell.Run(spec, seed=seed, seconds=seconds, trace=trace,
                       process_start=time.perf_counter(), device="cpu")
        return run, spec.driver.run(run)

    yield go
    torch.set_num_threads(threads)
