"""Each cell of BENCHMARK.json run on the card, as the check runs it, with a
short window: the last line is a result with `correct` true."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell,
                          "--seed", str(2 ** 31 + 101), "--seconds", "3",
                          "--trace", str(trace)],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["metrics"]
