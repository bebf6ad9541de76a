"""`ops.norm.bn_act`, the model's batch norm -> [residual join ->] ReLU
tails, on the CPU: its plain path against the module chain it replaced,
what the fused kernel takes, and the served model's names, calibration keys
and aten ops around it. The kernel itself is held against its plain version
on the GPU in tests/test_torch_cuda.py.
"""
import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from goldens import load_fixture
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops import quant
from octave_tpu_torch.ops.kernels import launch_counts
from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act, fused_bn_act_plain, takes
from octave_tpu_torch.ops.norm import BatchNorm2d, bn_act, fold_batch_stats, folded_inference

CL = torch.channels_last


def _norm(gen, c, dtype, mode):
    """A BatchNorm2d with drawn statistics and affine, folded for eval in
    mode 'folded', with raw statistics in 'eval', training in 'train'."""
    bn = BatchNorm2d(c)
    sd = {"weight": gen.uniform(0.5, 2, c), "bias": gen.uniform(-1, 1, c),
          "running_mean": gen.standard_normal(c), "running_var": gen.uniform(0.5, 2, c)}
    sd = {f"bn.{k}": torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    if mode == "folded":
        sd = fold_batch_stats(sd)
    sd = {k.removeprefix("bn."): v for k, v in sd.items()}
    bn.load_state_dict(sd, strict=False)
    bn.folded = mode == "folded"
    return bn.to(dtype).train(mode == "train")


def _chain(bn, x, residual, res_bn):
    """The module chain the model ran before `bn_act`: bn, the residual
    (through res_bn), the add, the ReLU."""
    y = bn(x)
    if residual is not None:
        y = y + (residual if res_bn is None else res_bn(residual))
    return F.relu(y)


@pytest.mark.parametrize("mode", ["folded", "eval", "train"])
@pytest.mark.parametrize("res", ["none", "raw", "bn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_path_equals_the_chain_bit_for_bit(mode, res, dtype):
    """On the CPU bn_act is the chain, bit for bit, in every mode (and the
    training statistics move as the chain moves them), and leaves x as it
    is; the kernel's plain version is the same folded chain. Nothing
    launches."""
    gen = np.random.default_rng(3)
    c = 32
    mk = lambda: torch.from_numpy(  # noqa: E731
        (gen.standard_normal((2, c, 5, 7)) * 3).astype(np.float32)).to(dtype, memory_format=CL)
    x, r = mk(), (mk() if res != "none" else None)
    norms = [_norm(np.random.default_rng(s), c, dtype, mode) for s in (1, 2)]
    twins = [_norm(np.random.default_rng(s), c, dtype, mode) for s in (1, 2)]
    res_bn, twin_res = (norms[1], twins[1]) if res == "bn" else (None, None)
    counts, x0 = launch_counts(), x.clone()
    got = bn_act(norms[0], x, r, res_bn)
    want = _chain(twins[0], x, r, twin_res)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(x, x0)
    for a, b in zip(norms, twins):
        assert torch.equal(a.running_mean, b.running_mean)
        assert torch.equal(a.running_var, b.running_var)
    if mode == "folded":
        affine = () if r is None else (r,) if res_bn is None else (r, res_bn.weight,
                                                                    res_bn.bias)
        with torch.no_grad():  # the norms' parameters would want a gradient
            assert torch.equal(fused_bn_act_plain(x, norms[0].weight, norms[0].bias, *affine),
                               want)
    assert launch_counts() == counts


def test_inplace_relu_writes_over_the_norm_output():
    """relu_inplace=True stands for an nn.ReLU(inplace=True): the plain
    path runs relu_ on bn's output, as that module did."""
    gen = np.random.default_rng(0)
    bn = _norm(gen, 8, torch.float32, "train")
    x = torch.from_numpy(gen.standard_normal((2, 8, 3, 3)).astype(np.float32))
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops():
        bn_act(bn, x, relu_inplace=True)
        bn_act(bn, x)
    assert [s for s in seen if "relu" in s] == ["aten.relu_.default", "aten.relu.default"]


def _case(dtype=torch.bfloat16, shape=(2, 32, 4, 6), res="bn", layout=CL):
    x = torch.randn(shape).to(dtype, memory_format=layout)
    c = shape[1]
    s, b = torch.randn(c).to(dtype), torch.randn(c).to(dtype)
    extra = {"none": (), "raw": (torch.randn(shape).to(dtype, memory_format=CL),),
             "bn": (torch.randn(shape).to(dtype, memory_format=CL), s.clone(), b.clone())}[res]
    return [x, s, b, *extra]


@pytest.mark.parametrize("case,ok", [
    ("bf16", True), ("f16", True), ("f32", True), ("raw", True), ("none", True),
    ("gap", True),  # (B, C, 1, 1): the split attention's bn1
    ("f64", False), ("nchw", False), ("residual_nchw", False), ("mixed_dtype", False),
    ("residual_shape", False), ("scale_shape", False), ("half_affine", False),
    ("affine_without_residual", False), ("grad", False), ("3d", False)])
def test_what_the_kernel_takes(case, ok):
    """`takes` admits channels-last activations of one floating dtype with
    (C,) affines and no gradient to record, and `fused_bn_act` raises on
    the rest; on what it admits the CPU's `fused_bn_act` raises too, since
    the kernel runs on CUDA alone."""
    args = {"bf16": lambda: _case(), "f16": lambda: _case(torch.float16),
            "f32": lambda: _case(torch.float32), "raw": lambda: _case(res="raw"),
            "none": lambda: _case(res="none"), "gap": lambda: _case(shape=(4, 64, 1, 1)),
            "f64": lambda: _case(torch.float64),
            "nchw": lambda: _case(layout=torch.contiguous_format)}.get(case, _case)()
    if case == "residual_nchw":
        args[3] = args[3].contiguous()
    elif case == "mixed_dtype":
        args[1] = args[1].float()
    elif case == "residual_shape":
        args[3] = args[3][:1]
    elif case == "scale_shape":
        args[1] = args[1][:16]
    elif case == "half_affine":
        args = args[:5]
    elif case == "affine_without_residual":
        args = [*args[:3], None, *args[4:]]
    elif case == "grad":
        args[1].requires_grad_()
    elif case == "3d":
        args = [args[0][0], *args[1:3]]
    assert takes(*args) is ok
    with pytest.raises(ValueError, match="on CUDA" if ok else "channels-last"):
        fused_bn_act(*args)


# -- the served model around bn_act --------------------------------------------
# The aten ops of one ResnestUNet forward (B = 2, 64², channels-last, the
# fused decoder) on the CPU, by name and count, as the model ran them with
# each tail as its module chain: training must run every one of them, in
# place where it was (relu_), and folded eval on the CPU, where the parity
# tests run, likewise.
FORWARD_OPS = {
    "train": {
        "_softmax.default": 26, "_unsafe_view.default": 5, "add.Tensor": 68,
        "add_.Tensor": 91, "alias.default": 2, "avg_pool2d.default": 7, "cat.default": 4,
        "convolution.default": 118, "detach.default": 118, "empty.memory_format": 91,
        "max_pool2d_with_indices.default": 1, "mean.dim": 21, "mm.default": 5,
        "mul.Tensor": 47, "native_batch_norm.default": 91, "permute.default": 13,
        "promote_types.default": 5, "relu.default": 79, "relu_.default": 13,
        "select.int": 42, "slice.Tensor": 47, "sum.dim_IntList": 5, "t.default": 5,
        "view.default": 94},
    "folded": {
        "_softmax.default": 26, "_unsafe_view.default": 5, "add.Tensor": 73,
        "addcmul.default": 86, "alias.default": 2, "avg_pool2d.default": 7, "cat.default": 4,
        "convolution.default": 118, "max_pool2d_with_indices.default": 1, "mean.dim": 21,
        "mm.default": 5, "mul.Tensor": 52, "permute.default": 18, "relu.default": 89,
        "relu_.default": 3, "select.int": 42, "slice.Tensor": 57, "sum.dim_IntList": 5,
        "t.default": 5, "view.default": 266},
}


@pytest.fixture(scope="module")
def unet():
    torch.manual_seed(0)
    return ResnestUNet(2, use_fused_decoder=True).to(memory_format=CL)


@pytest.mark.parametrize("mode", sorted(FORWARD_OPS))
def test_forward_runs_the_ops_it_ran(unet, mode):
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[str(func).removeprefix("aten.")] += 1
            return func(*args, **(kwargs or {}))

    folded_inference(unet, mode == "folded").train(mode == "train")
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    state = {k: v.clone() for k, v in unet.state_dict().items()}
    try:
        with Ops() as ops, torch.set_grad_enabled(mode == "train"):
            unet(x)
    finally:
        unet.load_state_dict(state)
        folded_inference(unet, False).eval()
    assert dict(ops.counts) == FORWARD_OPS[mode]


# the nn.ReLU modules whose ReLU a `bn_act` now applies: kept, under their
# Sequential indices, so the module tree and state dict are the reference's
_SKIPPED_RELUS = ["encoder_0_1_2.0.2", "encoder_0_1_2.0.5", "encoder_0_1_2.2"] + [
    f"decoder_{d}.conv.{i}" for d in range(5) for i in (2, 4)]


def test_served_model_keeps_its_names_and_calibration_keys(unet):
    """The state dict holds the reference's keys (the golden manifest's,
    less the classification heads, which the default build leaves out),
    the skipped ReLUs keep their indices, and calibration's conv pre-hooks
    see every conv the folded eval forward reads: each nn.Conv2d under its
    name but the gates' (which the fused epilogue reads as weights) and
    the paired decoder convs at depths 1-4, which record their two halves."""
    manifest, _, _ = load_fixture("unet112")  # built with the classification heads
    assert set(unet.state_dict()) == {k for k in manifest if not k.startswith("linear_head_")}
    modules = dict(unet.named_modules())
    assert len(modules) == 304
    assert all(type(modules[n]) is torch.nn.ReLU for n in _SKIPPED_RELUS)
    convs = {n for n, m in modules.items() if isinstance(m, torch.nn.Conv2d)}
    paired = {f"decoder_{d}.{c}" for d in range(1, 5) for c in ("conv.0", "downsample.0")}
    want = (convs - paired - {f"aag_{d}.conv1" for d in range(5)}
            | {f"{p}:{h}" for p in paired for h in "ab"} | {f"upsampling_{d}.up" for d in range(5)})
    folded_inference(unet).eval()
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    try:
        with torch.no_grad():
            stats = quant.calibrate(unet, [x], unet)
    finally:
        folded_inference(unet, False)
    assert set(stats) == want and len(want) == 126


@pytest.mark.parametrize("layout", ["nchw", "shape", "dtype"])
def test_fused_bn_act_refuses_an_out_laid_out_otherwise(layout):
    """`out` (x itself, as `bn_act` passes it, on the card) must be laid
    out as x: another layout, shape or dtype is refused before any launch,
    and x is left as it is."""
    x, s, b, r, rs, rb = _case(torch.float32)
    x0 = x.clone()
    out = {"nchw": lambda: torch.empty(x.shape),
           "shape": lambda: torch.empty_like(x[:1]),
           "dtype": lambda: torch.empty_like(x, dtype=torch.bfloat16)}[layout]()
    with pytest.raises(ValueError, match="laid out"):
        fused_bn_act(x, s, b, r, rs, rb, out=out)
    assert torch.equal(x, x0) and launch_counts()["bn_act"] == 0
