"""The port's weight bridge, npz reader and import isolation, on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from goldens import fill_state_dict, load_fixture
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops.norm import folded_inference
from octave_tpu_torch.utils.checkpoint import bf16_bits_to_f32, load_weights_npz
from octave_tpu_torch.utils.convert import from_jax_variables, load_reference_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "benchmarks", "weights304.npz")


def test_bridge_round_trip_is_bit_exact():
    """fill_state_dict -> convert_resnest_unet -> from_jax_variables gives
    back every original tensor, bit for bit (num_batches_tracked, which the
    JAX tree has no use for, aside)."""
    manifest, _, _ = load_fixture("unet112")
    sd = fill_state_dict(manifest)
    back = from_jax_variables(convert_resnest_unet(sd))
    want = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        got = back[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert np.array_equal(got.view(np.uint32), v.view(np.uint32)), k


def test_bridge_rejects_unmapped_leaves():
    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    variables["params"]["stray"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        from_jax_variables(variables)


def test_folded_jax_variables_load(rng):
    """Stats folded by the JAX package load into the port; marked folded,
    the port gives the raw-stats forward."""
    from octave_tpu.ops.norm import fold_batch_stats as jax_fold

    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    raw = load_reference_state_dict(ResnestUNet(2), from_jax_variables(variables)).eval()
    folded = load_reference_state_dict(ResnestUNet(2), from_jax_variables(
        jax_fold(variables))).eval()
    folded_inference(folded)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        (_, agg_raw, _), (_, agg_fold, _) = raw(x), folded(x)
    # float32 folding moves each BN's rounding: 50+ layers in series
    np.testing.assert_allclose(agg_fold.numpy(), agg_raw.numpy(), atol=2e-4)


def test_bf16_bits_decode_exactly():
    import ml_dtypes

    vals = np.array([0.0, -0.0, 1.0, -2.5, 3.140625, 1e-30, np.inf, 65504.0], np.float32)
    bits = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(bf16_bits_to_f32(bits).view(np.uint32), want.view(np.uint32))


def test_npz_reader_matches_jax_reader():
    """The committed serving shards read identically with the port's
    numpy-only reader and the JAX package's ml_dtypes one."""
    from octave_tpu.utils.checkpoint import load_weights_npz as jax_load

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    got = dict(flat(load_weights_npz(WEIGHTS)))
    want = dict(flat(jax_load(WEIGHTS)))
    assert set(got) == set(want) and len(got) > 500
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    sd = from_jax_variables(load_weights_npz(WEIGHTS))
    load_reference_state_dict(ResnestUNet(2), sd)


def test_npz_reader_rejects_incomplete_shards(tmp_path):
    np.savez(tmp_path / "w-shard0-of-2.npz", **{"bf16:a": np.zeros(2, np.uint16)})
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_weights_npz(str(tmp_path / "w.npz"))
    with pytest.raises(FileNotFoundError):
        load_weights_npz(str(tmp_path / "none.npz"))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py with the modules
    its main() imports, loads neither jax nor octave_tpu."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "import goldens\n"
        "import octave_tpu_torch\n"
        "for m in pkgutil.walk_packages(octave_tpu_torch.__path__, 'octave_tpu_torch.'):\n"
        "    if not m.name.split('.')[-1].startswith('triton_'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'flax', 'ml_dtypes', 'octave_tpu')\n"
        "             or n.startswith(('jax.', 'flax.', 'octave_tpu.')))\n"
        "print(len([n for n in sys.modules if n.startswith('octave_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 12, r.stdout
