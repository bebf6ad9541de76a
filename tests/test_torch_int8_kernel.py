"""The port's int8 conv kernel wrapper (octave_tpu_torch/ops/kernels/int8_conv.py)
and its build (ops/kernels/cuda_build.py) on the CPU.

On CPU tensors `int8_conv_nhwc` runs its plain version, the kernel's
function in PyTorch: it must equal the JAX package's `int8_conv` /
`int8_conv_transpose_2x2` bit for bit, in float32 and bf16, on every case of
tests/test_torch_quant.py::CONVS, under both ConvTranspose lowerings, and
for the decoder's pair (one conv per half, each dequantised and cast, then
added: octave_tpu/models/resnest.py:805-809). The kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py); here its arguments are
checked before any launch, and its build is held to what it promises with
the compiler stood in for.
"""
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from test_torch_quant import CONVS, DTYPES, _both, _conv_case
from octave_tpu.ops import common as jcommon
from octave_tpu.ops import quant as jq
from octave_tpu_torch.ops import common as tcommon
from octave_tpu_torch.ops import quant as tq
from octave_tpu_torch.ops.kernels import cuda_build
from octave_tpu_torch.ops.kernels import int8_conv as k8


def _sx(v: float) -> torch.Tensor:
    return torch.tensor(max(v, 1e-12), dtype=torch.float32)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("case", CONVS)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_conv_equals_jax(rng, dt, case):
    x, w, b, sx, c = _conv_case(rng, case, DTYPES[dt])
    p, s, g = c["p"], c["s"], c["g"]
    want = jq.int8_conv(x[0], w[0], b[0], sx, strides=(s, s), padding=[(p, p), (p, p)],
                        groups=g)
    wq, ws = tq.quantize_weight(w[1])
    mm, launches = tq.int8_mm.launches, k8.int8_conv_nhwc.launches
    got = k8.int8_conv_nhwc(_nhwc(x[1]), tq.pack_weight(wq, g), ws, _sx(sx), b[1],
                            tuple(w[1].shape[2:]), (s, s), (p, p))
    assert got.dtype == DTYPES[dt][1] and got.is_contiguous()
    assert tq.int8_mm.launches == mm + 1 and k8.int8_conv_nhwc.launches == launches
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["native", "einsum"])
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_transpose_equals_both_jax_lowerings(rng, dt, impl, monkeypatch):
    x = _both(rng.standard_normal((2, 5, 7, 16)), DTYPES[dt], (0, 3, 1, 2))
    w = _both(rng.standard_normal((16, 8, 2, 2)) * 0.1, DTYPES[dt])
    b = _both(rng.standard_normal(8), DTYPES[dt])
    sx = float(np.abs(np.asarray(x[0], np.float32)).max() / 127)
    monkeypatch.setattr(jcommon, "_CONV_TRANSPOSE_IMPL", impl)
    want = jq.int8_conv_transpose_2x2(x[0], w[0], b[0], sx)
    wq, ws = tq.quantize_weight(w[1], transpose=True)
    packed = tq.pack_weight(wq, transpose=True)
    for port_impl in ("native", "einsum"):  # the port's plain order either way
        tcommon.set_conv_transpose_impl(port_impl)
        try:
            got = k8.int8_conv_nhwc(_nhwc(x[1]), packed, ws, _sx(sx), b[1], transpose=True)
        finally:
            tcommon.set_conv_transpose_impl("native")
        assert got.shape == (2, 10, 14, 8)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("prepack", [True, False], ids=["prepacked", "per_call"])
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_pair_equals_jax_sum(rng, dt, prepack):
    """The pair mode's one call against JAX's two int8 convs and their sum
    (each half's own activation scale; per call, each half's own weight
    scales)."""
    a = _both(rng.standard_normal((2, 6, 6, 8)) * 3, DTYPES[dt], (0, 3, 1, 2))
    b = _both(rng.standard_normal((2, 6, 6, 16)), DTYPES[dt], (0, 3, 1, 2))
    k = _both(rng.standard_normal((3, 3, 24, 16)) * 0.1, DTYPES[dt], (3, 2, 0, 1))
    sa, sb = 3 * 3.5 / 127, 3.5 / 127
    pad = [(1, 1), (1, 1)]
    if prepack:
        wq, ws = jq.quantize_weight(k[0])
        want = (jq.int8_conv(a[0], wq[:, :, :8], None, jq.PackedScale(sa, ws), padding=pad)
                + jq.int8_conv(b[0], wq[:, :, 8:], None, jq.PackedScale(sb, ws), padding=pad))
        twq, tws = tq.quantize_weight(k[1])
        halves = ((tq.pack_weight(twq[:, :8]), tws), (tq.pack_weight(twq[:, 8:]), tws))
    else:
        want = (jq.int8_conv(a[0], k[0][:, :, :8], None, sa, padding=pad)
                + jq.int8_conv(b[0], k[0][:, :, 8:], None, sb, padding=pad))
        qa, qb = tq.quantize_weight(k[1][:, :8]), tq.quantize_weight(k[1][:, 8:])
        halves = ((tq.pack_weight(qa[0]), qa[1]), (tq.pack_weight(qb[0]), qb[1]))
    mm = tq.int8_mm.launches
    got = k8.int8_conv_nhwc(_nhwc(a[1]), halves[0][0], halves[0][1], _sx(sa), None, (3, 3),
                            padding=(1, 1),
                            pair=(_nhwc(b[1]), halves[1][0], halves[1][1], _sx(sb)))
    assert tq.int8_mm.launches == mm + 2  # the plain version: one GEMM a half
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_int8conv_pair_is_one_call(rng, monkeypatch):
    """An Int8Conv on a (skip, up) pair makes one int8_conv_nhwc call with
    the second input as its pair, prepacked and per call alike."""
    calls = []
    wrapped = k8.int8_conv_nhwc

    def spy(*args, **kw):
        calls.append(kw.get("pair") is not None)
        return wrapped(*args, **kw)

    monkeypatch.setattr(tq, "int8_conv_nhwc", spy)
    a, b = (torch.from_numpy(rng.standard_normal((2, c, 7, 7)).astype(np.float32))
            for c in (8, 16))
    conv = torch.nn.Conv2d(24, 16, 3, padding=1, bias=False)
    for prepack in (True, False):
        calls.clear()
        out = tq.Int8Conv(conv, (0.05, 0.03), prepack)((a, b))
        assert calls == [True] and out.shape == (2, 16, 7, 7)


def _args(**over):
    """Arguments of a small valid conv call (3x3, C 8 -> 16), with `over`."""
    wq, ws = tq.quantize_weight(torch.randn(16, 8, 3, 3))
    args = dict(x=torch.randn(2, 5, 5, 8), packed=tq.pack_weight(wq), ws=ws, sx=_sx(0.02),
                bias=None, kernel=(3, 3), stride=(1, 1), padding=(1, 1))
    args.update(over)
    return args


BAD = {
    "x_rank": dict(x=torch.randn(5, 5, 8)),
    "x_dtype": dict(x=torch.randn(2, 5, 5, 8).double()),
    "x_strided": dict(x=torch.randn(2, 8, 5, 5).permute(0, 2, 3, 1)),
    "packed_dtype": dict(packed=torch.zeros(16, 72, dtype=torch.int32)),
    "packed_short": dict(packed=torch.zeros(16, 64, dtype=torch.int8)),
    "packed_rows": dict(packed=torch.zeros(8, 72, dtype=torch.int8)),
    "packed_pitch": dict(packed=torch.zeros(16, 74, dtype=torch.int8)),
    "ws_dtype": dict(ws=torch.ones(16, dtype=torch.float64)),
    "sx_two": dict(sx=torch.ones(2)),
    "bias_shape": dict(bias=torch.zeros(15)),
    "bias_dtype": dict(bias=torch.zeros(16, dtype=torch.float16)),
    "no_output": dict(kernel=(9, 9), padding=(0, 0)),
    "stride_zero": dict(stride=(0, 1)),
    "pair_with_bias": dict(bias=torch.zeros(16), pair=(torch.randn(2, 5, 5, 8),
                                                        torch.zeros(16, 72, dtype=torch.int8),
                                                        torch.ones(16), _sx(0.1))),
    "pair_shape": dict(pair=(torch.randn(2, 4, 5, 8), torch.zeros(16, 72, dtype=torch.int8),
                             torch.ones(16), _sx(0.1))),
    "pair_dtype": dict(pair=(torch.randn(2, 5, 5, 8).bfloat16(),
                             torch.zeros(16, 72, dtype=torch.int8), torch.ones(16), _sx(0.1))),
    "pair_packed": dict(pair=(torch.randn(2, 5, 5, 16), torch.zeros(16, 72, dtype=torch.int8),
                              torch.ones(16), _sx(0.1))),
    "two_devices": dict(x=torch.empty(2, 5, 5, 8, device="meta")),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_arguments_raise_before_any_launch(bad, monkeypatch):
    """Every argument the kernel does not take raises before the wrapper
    reaches a launch or its plain version; a device without an
    implementation raises too (no fallback)."""
    def reached(*a, **k):
        raise AssertionError("reached a launch")

    monkeypatch.setattr(k8, "_launch", reached)
    monkeypatch.setattr(k8, "int8_conv_nhwc_plain", reached)
    with pytest.raises((ValueError, TypeError)):
        k8.int8_conv_nhwc(**_args(**BAD[bad]))


def test_a_device_without_an_implementation_raises(monkeypatch):
    monkeypatch.setattr(k8, "int8_conv_nhwc_plain", lambda *a, **k: "plain")
    args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in _args().items()}
    with pytest.raises(ValueError, match="no implementation for device meta"):
        k8.int8_conv_nhwc(**args)


def test_valid_arguments_reach_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(k8, "int8_conv_nhwc_plain", lambda *a, **k: seen.append(a) or "plain")
    assert k8.int8_conv_nhwc(**_args()) == "plain" and len(seen) == 1


# -- the path the kernel took ---------------------------------------------------------
def test_path_counters_are_registered():
    from octave_tpu_torch.utils import profiling

    names = {f"int8_conv.path.{p}" for p in ("wgmma", "halo", "tap")}
    assert names <= set(profiling.counters()) and set(k8.path_counters) == {"wgmma", "halo", "tap"}
    assert {c.counter for c in k8.path_counters.values()} == names


class _FakeLib:
    """The kernels' library standing in for the card: records each call of
    the entry point and reports `path` through its out-parameter."""

    def __init__(self, path=2, err=0):
        self.path, self.err, self.calls = path, err, []

    def octave_int8_conv(self, *args):
        self.calls.append(args)
        args[-1]._obj.value = self.path
        return self.err

    def octave_cuda_error(self, err):
        return b"an error of the card"


def _fake_launch(monkeypatch, lib, **over):
    """`_launch` on CPU tensors with the card's pieces stood in for: the
    library, its attributes, the device and the stream."""
    import contextlib
    import types

    monkeypatch.setattr(cuda_build, "load", lambda: lib)
    monkeypatch.setattr(k8, "_ready", lambda lib, device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    a = _args(**over)
    b, h, w, _ = a["x"].shape
    n = a["ws"].shape[0]
    return k8._launch(a["x"], a["packed"], a["ws"], a["sx"], a["bias"], a["kernel"], a["stride"],
                      a["padding"], (1, 1), False, None, (b, h, w, h, w, n, n))


@pytest.mark.parametrize("code,path", [(0, "tap"), (1, "halo"), (2, "wgmma")])
def test_launch_counts_the_path_the_kernel_reports(monkeypatch, code, path):
    """Each launch counts `launches.int8_conv` and the path the entry point
    reported, once; without `forced_path` it asks for the shape's own
    choice (-1), inside it for that path's code."""
    from octave_tpu_torch.utils import profiling

    lib = _FakeLib(path=code)
    before = profiling.counters()
    out = _fake_launch(monkeypatch, lib)
    assert out.shape == (2, 5, 5, 16) and lib.calls[-1][-2] == -1
    after = profiling.counters()
    for name in k8.PATHS:
        key = f"int8_conv.path.{name}"
        assert after[key] - before[key] == (name == path), name
    assert after["launches.int8_conv"] - before["launches.int8_conv"] == 1
    with k8.forced_path(path):
        _fake_launch(monkeypatch, lib)
    assert lib.calls[-1][-2] == code and profiling.counter(f"int8_conv.path.{path}") == \
        after[f"int8_conv.path.{path}"] + 1


def test_a_failed_launch_counts_nothing(monkeypatch):
    from octave_tpu_torch.utils import profiling

    before = profiling.counters()
    with pytest.raises(RuntimeError, match="an error of the card"):
        _fake_launch(monkeypatch, _FakeLib(err=1))
    with pytest.raises(RuntimeError, match="reported no path"):
        _fake_launch(monkeypatch, _FakeLib(path=-1))
    after = profiling.counters()
    assert all(after[k] == before[k] for k in before if k.startswith(("int8_conv.", "launches.")))
    with pytest.raises(ValueError, match="not one of"):
        with k8.forced_path("mma"):
            pass


def test_a_captured_launch_counts_its_path_at_each_replay(monkeypatch):
    """Inside `record_launches` (a CUDA-graph capture) the path goes to the
    tally with the launch, and each replay's `add_launches` counts both."""
    from octave_tpu_torch.ops.kernels import add_launches, record_launches

    wgmma = k8.path_counters["wgmma"]
    n0, launches0 = wgmma.launches, k8.int8_conv_nhwc.launches
    with record_launches() as tally:
        _fake_launch(monkeypatch, _FakeLib(path=2))
    assert tally == {k8.int8_conv_nhwc: 1, wgmma: 1} and wgmma.launches == n0
    add_launches(tally)
    add_launches(tally)
    assert wgmma.launches == n0 + 2 and k8.int8_conv_nhwc.launches == launches0 + 2


# -- the build ---------------------------------------------------------------------
def test_build_names_hopper_and_no_contraction():
    cmd = cuda_build.compile_command(cuda_build.sources()[0], cuda_build.BUILD_DIR / "x.o")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert {"-O3", "-std=c++17", "-Xcompiler", "-fPIC"} <= set(cmd)
    assert "-shared" in cuda_build.link_command([], cuda_build.BUILD_DIR / "x.so")
    assert cuda_build.BUILD_DIR.parts[-2:] == ("build", "cuda")
    names = {p.name for p in cuda_build.sources()}
    assert names == {p.name for p in cuda_build.CSRC.iterdir() if p.suffix == ".cu"}
    for part in ("", "_halo", "_sm90"):  # one nvcc per source: each path's dtypes apart
        assert {f"int8_conv{part}_{t}.cu" for t in ("f32", "bf16", "f16")} <= names, part
    assert "int8_conv.cu" in names
    assert {p.name for p in cuda_build.headers()} >= {"int8_conv.cuh", "int8_conv_sm90.cuh"}


def _copy_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in cuda_build.sources() + cuda_build.headers():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build" / "cuda")
    return csrc


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    csrc = _copy_sources(tmp_path, monkeypatch)
    first = cuda_build.library_path()
    assert first.parent == tmp_path / "build" / "cuda"
    assert first.name.startswith("liboctave_kernels-") and first.suffix == ".so"
    assert cuda_build.library_path() == first
    for name in ("int8_conv.cuh", "int8_conv_f32.cu"):
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert cuda_build.library_path() != first, name
        path.write_text(text)
    assert cuda_build.library_path() == first


class _FakeNvcc:
    """subprocess.Popen standing in for nvcc: records each command, writes
    its -o file unless told to fail."""

    def __init__(self, fail_on=None):
        self.cmds, self.fail_on = [], fail_on

    def __call__(self, cmd, **kw):
        self.cmds.append(cmd)
        fake = self

        class Proc:
            returncode = 0

            def communicate(self, timeout=None):
                if fake.fail_on and fake.fail_on in " ".join(cmd):
                    self.returncode = 1
                    return "int8_conv.cu(12): error: identifier \"oops\" is undefined\n", None
                with open(cmd[cmd.index("-o") + 1], "w") as f:
                    f.write("built")
                return "ptxas info    : Used 128 registers\n", None

            def kill(self):
                pass

            def wait(self):
                return self.returncode

        return Proc()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    _copy_sources(tmp_path, monkeypatch)
    fake = _FakeNvcc()
    monkeypatch.setattr(subprocess, "Popen", fake)
    path = cuda_build.build()
    assert path == cuda_build.library_path() and path.read_text() == "built"
    compiles = [c for c in fake.cmds if "-c" in c]
    assert len(compiles) == len(cuda_build.sources()) == len(fake.cmds) - 1
    assert "-shared" in fake.cmds[-1]
    assert "Used 128 registers" in cuda_build.build_log
    assert sorted(os.listdir(path.parent)) == [path.name]  # objects and temp file gone


def test_failing_compile_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _copy_sources(tmp_path, monkeypatch)
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc(fail_on="int8_conv_bf16.cu"))
    monkeypatch.setattr(cuda_build, "_lib", None)
    with pytest.raises(RuntimeError, match="identifier \"oops\" is undefined"):
        cuda_build.load()
    assert not cuda_build.library_path().exists()
    assert cuda_build._lib is None  # nothing loaded, nothing to fall back to
    assert not any(p.suffix == ".o" for p in cuda_build.BUILD_DIR.iterdir())


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    _copy_sources(tmp_path, monkeypatch)

    def no_nvcc(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "Popen", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc did not run"):
        cuda_build.build()
