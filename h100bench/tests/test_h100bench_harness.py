"""The harness on the CPU: finding cells by their files, the per-layer
readers, the operation counts, and what may be loaded or read."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT


def test_cells_and_metrics_are_found_by_name_from_new_files(tmp_path):
    """A cell, a configuration and a per-layer metric added as files and
    BENCHMARK.json entries, no file of the harness edited."""
    from harness import cell

    bench = tmp_path / "h100bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cfg = json.loads((bench / "configs" / "octave-unet304-int8-serve.json").read_text())
    cfg["image_size"] = 400
    (bench / "configs" / "octave-unet400-int8-serve.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "serve-int8-bulk-b256.json").read_text())
    wl.update(config="octave-unet400-int8-serve", batch=128)
    (bench / "workloads" / "serve-int8-bulk-b128-400.json").write_text(json.dumps(wl))
    (bench / "metrics" / "dispatches.bulk400.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    spec["configs"].append({"name": "octave-unet400-int8-serve", "source": "x",
                            "file": "h100bench/configs/octave-unet400-int8-serve.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "serve-int8-bulk-b128-400",
                              "config": "octave-unet400-int8-serve", "traffic": "bulk",
                              "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("serve-int8-bulk-b128-400")
    spec["per_layer"].append({"name": "dispatches.bulk400", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "serve.Predictor",
                              "moves": "serve_img_s",
                              "workloads": ["serve-int8-bulk-b128-400"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    got = cell.load(str(tmp_path), "serve-int8-bulk-b128-400", str(bench))
    assert got.config["image_size"] == 400 and got.workload["batch"] == 128
    assert got.driver.__file__.endswith("bulk_stream.py")
    assert "dispatches.bulk400" in got.readers
    assert {m["name"] for m in got.end_to_end} >= {"serve_img_s", "setup_s", "peak_gib"}
    with pytest.raises(KeyError):
        cell.load(str(tmp_path), "no-such-cell", str(bench))


def test_every_cell_of_benchmark_json_loads_with_its_metrics():
    from harness import cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        got = cell.load(ROOT, w["name"])
        names = {m["name"] for m in got.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert got.per_layer and set(got.readers) == {m["name"] for m in got.per_layer}
        for m in got.per_layer:
            assert m["moves"] in names


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    from harness.report import forbidden_modules

    assert forbidden_modules(["octave_tpu_torch", "octave_tpu_torch.serve", "torch"]) == []
    assert forbidden_modules(["octave_tpu.models.resnest"]) == ["octave_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


PROBE = r"""
import sys, os
sys.path[:0] = [{bench!r}, {root!r}]
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args
                 and isinstance(args[0], (str, bytes, os.PathLike)) else None)
import torch
torch.set_num_threads(2)
import time
from harness import cell, report
spec = cell.load({root!r}, "serve-int8-bulk-b256")
spec.config.update(image_size=64, calibration_images=4, bn_statistics_images=4)
spec.workload.update(batch=2, distinct_batches=2, sample_dispatches=2)
run = cell.Run(spec, 5, 0.3, False, time.perf_counter(), device="cpu")
spec.driver.run(run)
for m in list(spec.readers.values()):
    pass
print("FORBIDDEN", report.forbidden_modules(sys.modules))
bench_dir = os.path.join({root!r}, "benchmarks")
print("BENCHMARKS", [p for p in opened if os.path.abspath(p).startswith(bench_dir + os.sep)])
"""


def test_a_run_loads_no_jax_and_reads_nothing_under_benchmarks():
    """A serving run on the CPU at a tiny size, in a fresh interpreter:
    no module named jax, jaxlib, flax or octave_tpu is loaded, and no path
    under the JAX package's benchmarks/ is opened."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH, root=ROOT)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("FORBIDDEN", "BENCHMARKS")))
    assert lines["FORBIDDEN"] == "[]"
    assert lines["BENCHMARKS"] == "[]"


def _reading(**kw):
    from harness.trace import Reading

    cfg = json.load(open(os.path.join(BENCH, "configs", "octave-unet304-int8-serve.json")))
    base = dict(kernels=[("int8_conv_halo_kernel<bf16>", 0.0, 0.2),
                         ("decoder_epilogue_kernel", 0.2, 0.25),
                         ("Memcpy HtoD (Pinned -> Device)", 0.25, 0.26),
                         ("void cudnn_conv", 0.3, 0.5)],
                host=[("cudaGraphLaunch", 0.0, 0.01), ("cudaEventSynchronize", 0.26, 0.31)],
                window_s=0.6, units=1, images=256, config=cfg,
                workload={"batch": 256}, t0=0.0)
    base.update(kw)
    return Reading(**base)


def test_readers_on_a_synthetic_profile():
    from harness import cell, roofline

    spec = cell.load(ROOT, "serve-int8-bulk-b256")
    r = _reading()
    sites = r.config["per_image"]["int8_sites"]
    got = {name: mod.read(r) for name, mod in spec.readers.items()}
    assert got["int8_conv.roofline.bulk"] == pytest.approx(
        100 * roofline.int8_forward_bound_s(sites, 256) / 0.2)
    assert got["epilogue.roofline.bulk"] == pytest.approx(
        100 * roofline.epilogue_bound_s(r.config["per_image"]["epilogue_depths"], 256, 2)
        / 0.05)
    assert got["copy_ms.bulk"] == pytest.approx(10.0)
    assert got["idle.bulk"] == pytest.approx(100 * (0.6 - 0.46) / 0.6)
    per = r.config["per_image"]
    assert got["mfu.bulk"] == pytest.approx(
        100 * 256 / 0.6 * (per["bf16_flops"] / 989e12 + per["int8_ops"] / 1979e12))
    # a reader with nothing to read returns nothing, never 0
    empty = _reading(kernels=[], images=0)
    assert all(mod.read(empty) is None for mod in spec.readers.values())
    # the gaps are put down to what the host was doing
    b = r.breakdown()
    assert b["device_ops"][0] == ["int8_conv_halo_kernel<bf16>", pytest.approx(0.2)]
    labels = dict((k, v) for k, v in b["idle_gaps"])
    assert labels["cudaEventSynchronize"] == pytest.approx(0.04)
    assert labels["no host event"] == pytest.approx(0.1)


def test_train_readers_on_a_synthetic_profile():
    from harness import cell

    spec = cell.load(ROOT, "train-adv-b8-k1")
    cfg = spec.config
    r = _reading(config=cfg, images=80)
    got = {name: mod.read(r) for name, mod in spec.readers.items()}
    assert got["mfu.train"] == pytest.approx(
        100 * cfg["per_image"]["train_flops"] * 80 / (989e12 * 0.6))
    assert got["idle.train"] == pytest.approx(100 * (0.6 - 0.46) / 0.6)


def test_operation_counts_of_the_configuration_files_recompute():
    import count_ops

    got = count_ops.counts()
    for name, values in got.items():
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            assert json.load(f)["per_image"] == values
    serve = got[count_ops.SERVE]
    # 25 launches a forward, 2,077.5 GOP at B = 32 (the int8 kernel's table)
    assert len(serve["int8_sites"]) == 25
    assert serve["int8_ops"] * 32 == pytest.approx(2077.5e9, rel=1e-3)
