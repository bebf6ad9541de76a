"""The port's serving benchmark (`octave_tpu_torch/bench.py`, `cli bench`)
against the JAX package's root `bench.py`, and the Predictor's tensor input,
on the CPU.

The phantoms and the committed weights must equal the JAX bench's, element
for element. `main` runs at B = 4, 32², k = 2 on the CPU: the record's keys,
the agreement gate in both directions (at 32² the int8 masks agree with
bf16's on ~0.98 of pixels, below the gate, since the weights were trained at
304²), and the fallback when an int8 Predictor's masks disagree. A tensor
given to `predict_many_device` or `__call__` on the CPU must give the numpy
path's output bit for bit. On the card: chip_smoke.py phase 12 and
tests/test_torch_cuda.py.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu_torch import bench
from octave_tpu_torch.serve import Predictor
from octave_tpu_torch.utils.convert import from_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "per_call_img_s", "int8_mask_agreement", "device"}
SMALL = dict(batch=4, hw=32, k=2, device="cpu")


@pytest.fixture(scope="module")
def jax_bench():
    """The repository's root bench.py (it imports JAX and the JAX package
    only inside its functions)."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("batch,hw", [(8, 32), (70, 16)])  # 70: past the 64-image tiling
def test_phantom_batch_equals_jax(jax_bench, batch, hw):
    got = bench.phantom_batch(batch, hw)
    want = jax_bench.phantom_batch(batch, hw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (batch, hw, hw, 3)
    np.testing.assert_array_equal(got, want)


def test_trained_variables_equal_jax(jax_bench):
    variables, label = jax_bench.load_trained_variables()
    assert label == "trained weights304.npz"
    want = from_jax_variables(variables)
    got = bench.load_trained_variables()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_missing_weights_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "WEIGHTS", str(tmp_path / "weights304.npz"))
    with pytest.raises(FileNotFoundError):
        bench.load_trained_variables()


def _record(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == KEYS
    assert record["unit"] == "images/sec/chip" and record["device"] == "cpu"
    assert record["value"] > 0 and record["per_call_img_s"] > 0
    assert 0.0 <= record["int8_mask_agreement"] <= 1.0
    return record


def test_main_prints_one_record_and_gates(capsys):
    run = bench.main(**SMALL)
    record = _record(capsys)
    assert record == run.record
    agreement = record["int8_mask_agreement"]
    assert agreement == round(bench.mask_agreement(run.int8, run.bf16, run.images), 5)
    if agreement >= bench.AGREEMENT_GATE:
        assert run.served is run.int8
        assert "bf16 + int8 dense-lowered decoder (prepacked)" in record["metric"]
    else:
        assert run.served is run.bf16
        assert f"bf16 (int8 agreement gate {agreement:.4f})" in record["metric"]
    assert run.int8.int8_scales and run.bf16.int8_scales is None
    assert run.images.shape == (4, 32, 32, 3)


def test_main_serves_int8_at_or_above_the_gate(capsys, monkeypatch):
    monkeypatch.setattr(bench, "AGREEMENT_GATE", 0.0)
    run = bench.main(**SMALL)
    record = _record(capsys)
    assert run.served is run.int8
    assert record["metric"].startswith(
        "32x32 en-face inference images/sec/chip (ResnestUNet bf16 + int8 dense-lowered "
        "decoder (prepacked), aggregated-dispatch serving path, trained weights304.npz)")


class _Disagreeing:
    """An int8 Predictor whose probabilities are the bf16 ones, class for
    class swapped: it agrees with bf16 only where two classes tie."""

    def __init__(self, weights, **kw):
        kw = {k: v for k, v in kw.items()
              if k not in ("int8_decoder", "calibration_batches", "dense_groups")}
        self.inner = Predictor(weights, **kw)

    def __call__(self, x):
        return self.inner(x)[..., ::-1]


def test_main_falls_back_to_bf16_below_the_gate(capsys, monkeypatch):
    def predictor(weights, **kw):
        return _Disagreeing(weights, **kw) if kw.get("int8_decoder") else Predictor(weights, **kw)

    monkeypatch.setattr(bench, "Predictor", predictor)
    run = bench.main(**SMALL)
    record = _record(capsys)
    agreement = record["int8_mask_agreement"]
    assert agreement < 0.01
    assert run.served is run.bf16 and isinstance(run.int8, _Disagreeing)
    assert f"ResnestUNet bf16 (int8 agreement gate {agreement:.4f})" in record["metric"]
    assert "int8 dense-lowered" not in record["metric"]
    assert "degraded" not in record


@pytest.fixture(scope="module")
def predictors():
    """A single and a two-replica CPU Predictor on the same random weights."""
    single = Predictor.initialize(device="cpu")
    fanned = Predictor.initialize(device="cpu", mesh=("cpu", "cpu"))
    return {"single": single, "mesh": fanned}


@pytest.mark.parametrize("which", ["single", "mesh"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_tensor_input_equals_numpy_path(predictors, which, k, dtype):
    pred = predictors[which]
    rng = np.random.default_rng(5)
    stack = rng.uniform(0, 1, (k, 2, 16, 16, 3)).astype(np.float32)
    if dtype == np.uint8:
        stack = (stack * 255).astype(np.uint8)
    want = np.asarray(pred.predict_many_device(stack))
    got = np.asarray(pred.predict_many_device(torch.from_numpy(stack)))
    assert got.shape == (k, 2, 16, 16, 2)
    np.testing.assert_array_equal(got, want)
    # a non-contiguous tensor view, and __call__ on a tensor batch
    view = torch.from_numpy(np.ascontiguousarray(stack.transpose(0, 1, 3, 2, 4))).transpose(2, 3)
    np.testing.assert_array_equal(np.asarray(pred.predict_many_device(view)), want)
    np.testing.assert_array_equal(pred(torch.from_numpy(stack[0])), pred(stack[0]))
