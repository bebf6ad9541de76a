#!/usr/bin/env python3
"""GPU smoke test of octave_tpu_torch: builds its kernels (Triton and CUDA
C++) and drives its serving and training paths on one NVIDIA GPU. Run from
the repository root:

    python3 chip_smoke.py

Phases 3-14 check the port's behaviour on the card; phases 1, 2 and 15-16
and the lowering and Upsampling tables of phases 10 and 11 time single
kernels and ops at fixed shapes (L2 flushed), each beside a bound or a
yardstick. Whole paths are timed by the benchmark (h100bench/), not here.
Each phase prints its own lines:
  1. build   - compiles the CUDA C++ int8 conv kernel from this checkout's
               csrc/ into build/cuda (emptied first; one nvcc per source,
               started together, then linked; registers and spills of each
               instance logged) while both Triton kernels compile into
               build/triton (emptied first) in float32, bfloat16 and
               float16; the build times;
  2. kernels - each Triton kernel against its plain PyTorch version at the
               five decoder shapes of the 304² forward, in float32 with
               B = 8, in bfloat16 with B = 8 and B = 32 (the serving batch)
               and in float16 with B = 8, and the decoder epilogue in
               bfloat16 at the bench's B = 256: within kernel_tolerance,
               with median times (L2 flushed before every launch) and the
               byte bound; the kernels JSON line carries the bf16 B = 32
               figures (and the epilogue's B = 256 ones under
               "at_bench_batch");
  3. golden  - the port's ResnestUNet in float32 (TF32 off) at 304² on the
               reference fill of tests/golden/unet304.npz, through the fused
               epilogue and through the AAG kernel (5 launches of one):
               within 1e-3 of the reference's stored outputs (as
               tests/test_golden.py);
  4. serve   - Predictor on the committed trained weights (bf16, folded BN,
               uint8 input, 304², B = 32): the launch counts of each serving
               path (__call__, the main path; predict_many k = 4; mask_u8;
               the unfused AAG configuration); probabilities finite and
               summing to 1; the paths' masks agreeing (>= 0.999) and the
               mask agreeing with the plain float32 path on the CPU
               (>= 0.995);
  5. train   - the adversarial trainer from the default Config (304², B = 8,
               ResnestUNet + critic of depth 4 and 64 filters, noise on):
               Trainer.fit for 3 steps and evaluate, the main path, with 5
               AAG launches per train step and per eval batch and metrics in
               [0, 1]; the AAG Function's forward and backward at the five
               train shapes against the float64 formula, x in float32 and
               bf16 and, as the step under autocast calls it, float32 x gated
               in bf16 and in float16; one float32 step (TF32 off, noise off)
               against the same step on the CPU through the plain AAG
               (losses, each player's gradient); one bf16 step against one
               float32 step (losses within 5%); 20 bf16 steps on one batch
               (finite, all four kinds of state move, loss_sup falls);
  6. deploy  - the deployment path at 304²: 32 + 16 phantoms written as PNGs
               into a ROSE tree and read back equal; `cli train` on that
               folder with augmentation, bf16, a checkpoint and a profiler
               trace (4 logged steps, 5 AAG launches per step and eval
               batch, the trace written), resumed to step 6; a checkpoint of
               the live state restored into a fresh state, exact; an
               augmented batch contiguous; `cli eval --checkpoint` and the
               restored state's evaluate against the live state's metrics;
               the weights exported to the compact npz, read back as their
               bf16 rounding and predicting alike; `cli predict` over the 16
               test PNGs against the Predictor called directly (5 epilogue
               launches per batch); `BatchServer` on the committed trained
               weights (bf16, B = 32, ks (1, 2, 4), depth 2): 300 images in
               order against the direct path, launches 5 x the sum of the
               dispatched k, k > 1 under flood, a flood of 1,280 from a
               generator all returned, k = 1 for a lone request, recovery
               from an injected out-of-memory at k = 4, and mask_u8 through
               the server;
  7. family  - the rest of the model family: the dual decoders' goldens
               (phg112 through the AAG kernel and the fused epilogue, 6
               launches each; ph112) in float32; `cli train
               model.architecture=parallel_head_gate` on a ROSE tree with
               thick_gt and thin_gt (304², B = 8, bf16, augmentation, critics
               main depth 4 and c depth 1, 4 steps, 7 AAG launches per step
               and eval batch, the c critic's depth clamp logged), restore
               exact, every kind of state moved, `cli eval --checkpoint`
               printing the live metrics; one float32 dual-critic step on
               the card against the CPU (112², B = 2), beside a float32
               witness; the fused dual-decoder eval forward (7 epilogue
               launches) against the unfused one in bf16 (>= 0.999);
               `octa_scribble_net` with encoder gating (5 AAG launches, 5
               gates of 16 channels summing to 1, finite critic logits);
  8. parallel - the native loader and data parallelism: the C++ loader built
               from this checkout into build/native (emptied first); the
               committed TIFF fixtures against their expected arrays; a 304²
               image as PNG with each row filter, BMP and PGM through the
               loader and the numpy reader (identical), as TIFF uncompressed
               and LZW; a ROSE tree of TIFFs (16 + 13 phantoms at 304²) read
               back equal, and `cli train train.data_parallel=true
               train.n_devices=1` on it as one rank of a torchrun-style
               group (NCCL; B = 8, float32 TF32 off, noise off, 3 steps and
               evaluate, 5 AAG launches per step and eval batch) against the
               same run on one device, beside a witness (one device from
               weights one float32 rounding away); one step of that rank
               against one device's (losses, gradient), and in bf16 (losses
               finite, within 5%); two ranks on the one card over gloo (CUDA
               tensors): one float32 step at global B = 8 against the full
               batch on one device (losses, gradient, BN stats) and
               `evaluate` with a ragged tail against one device's metrics;
  9. int8    - the int8 Predictor (post-training quantisation) on the
               committed trained weights at 304², bf16, calibrated on 32
               phantoms: 33 scales and 25 int8 convs (scope decoder); masks
               against the bf16 Predictor's on the phase 4 phantoms (argmax
               agreement >= 0.99, the JAX package's gate; scope all >= 0.98)
               through the fused epilogue (5 launches per __call__, 5 x k in
               predict_many, equal to __call__), at int8_scope="all", with
               use_fused_decoder=False (5 AAG launches) and at B = 1 and 8,
               each with its int8 conv kernel launches counted (25 per
               decoder-scope forward: five convs a decoder, a pair in one
               launch; one per int8 conv in scope all) and no library int8
               GEMM; `cli predict --int8` on phase 6's PNG folder and
               checkpoint against an int8 Predictor called directly
               (calibrated on the same first batch);
 10. switches - the memory and lowering switches: every grouped conv shape
               of the 304² UNet's train forward at B = 8 through the dense
               and einsum lowerings against cuDNN's grouped conv (forward
               and both backwards, float32 with TF32 off and bf16, max error
               against cuDNN float32 within its bound, fwd+bwd ms of each,
               L2 flushed); Predictor(dense_groups="decoder") and
               Predictor(einsum_groups="decoder+enc") beside the default one
               at B = 32 (argmax agreement >= 0.999, 5 epilogue launches per
               call); one bf16 `unet` step at 304², B = 8 per remat mode
               (False, True, 'conv', 'block', 'block-enc', 'block:012',
               'block:01e34', 'block:012+conv') from the same state and
               batch: AAG launches (10 where the region holds the gates,
               else 5), step-1 losses, BN running statistics and
               num_batches_tracked against remat=False; the same modes in
               float32 (TF32 off) against remat=False beside a witness one
               float32 rounding away (`nudge_`); the bf16 Adam moment's
               bytes against fused Adam's (2 bytes saved per parameter);
               `cli train` with steps_per_call=2, remat=block:012,
               dense_groups=decoder:01 and the bf16 moment for 4 steps
               (logged steps, the checkpoint cadence crossed at step 4, 25
               AAG launches, restore equal to the checkpoint with exp_avg in
               bf16, `cli eval --checkpoint` printing train's metrics);
               Trainer.fit at steps_per_call 1, 2 and 4 ending at step 36;
 11. surface  - the rest of the JAX package's surface: one float16 `unet`
               step at 304², B = 8 (noise off) against float32 from the same
               state and batch (losses 5%, 5 AAG launches gating in float16,
               the largest float16 logits finite), 10 float16 steps (finite,
               loss_sup falls), `cli train train.compute_dtype=float16` for 2
               steps on a ROSE tree of PNGs; `Predictor(mesh=make_mesh())`
               and `Predictor(mesh=(cuda:0, cuda:0))` against the single
               Predictor (argmax agreement >= 0.999, 5 epilogue launches per
               replica per call, 20 per replica for predict_many k = 4), a
               BatchServer flood of 128 through the two replicas in order;
               the Predictor under set_conv_transpose_impl("einsum") against
               "native" (agreement, 5 launches) and the five Upsampling
               shapes of a 304², B = 8 forward timed under each lowering (L2
               flushed); a float16 Predictor (5 epilogue launches in
               float16, agreement with bf16 >= 0.995);
 12. bench    - `cli bench`'s configuration, `octave_tpu_torch.bench.main()`
               at its defaults (the committed weights, int8 decoder
               prepacked and dense-lowered behind the 0.99 agreement gate,
               B = 256, k = 4, inputs on the device): its JSON record's keys,
               device and gate (the rates left out of the log), 195 epilogue
               launches (5 per forward: 1 calibration, 2 gate, 8 per-call and
               7 x 4 dispatched), 925 int8 conv kernel launches (25 per int8
               forward: 1 gate, 8 per-call, 7 x 4) and no AAG launch or
               library int8 GEMM, the served Predictor and the agreement;
               the k = 4 dispatch's first batch against one call (argmax
               agreement >= 0.9999);
 13. graph    - the train step as one CUDA-graph replay per call (on CUDA
               every `Trainer.fit` of phases 5-12 runs so, data parallelism
               excepted): C.8 on the card (a fresh ResnestUNet's 87 backbone
               conv stds against sqrt(2/(kh kw out))); Trainer.fit graphed
               against eager in float32 (TF32 off, deterministic
               algorithms, noise on, B = 2 at 128², a schedule that moves),
               bit for bit in every call's losses and every state leaf
               (parameters, BN statistics, spectral u/v, moments, schedule,
               generator), for `unet` and `parallel_head_gate` at
               steps_per_call 1, 2 and 4, the bf16 moment at 2 and each
               remat mode at 1 (where they differ, the eager-against-eager
               spread beside it, which the graph must not exceed); AAG
               launches through the replays (5 per `unet` step, 7 per
               `parallel_head_gate` step, 10 where the remat region holds
               the gates); a graphed fit to step 2 resumed to step 4 against
               the graphed fit to step 4; at 304², B = 8, bf16, default
               Config, `unet` and `parallel_head_gate`: the graphed step
               captured, one eager and one graphed call's launches, and the
               graphed Trainer.fit's peak memory at steps_per_call 2 and 4
               within 1.25x of 1's;
 14. graphed  - serving and evaluation as CUDA-graph replays (on CUDA every
               Predictor, BatchServer and Trainer.evaluate of phases 4-13
               runs so, calibration excepted): float32 (TF32 off,
               deterministic algorithms) graphed Predictors against eager
               ones at 304², B = 8, bit for bit, predict_many at k = 1, 2, 4
               and __call__, fused and unfused, 5 kernel launches per
               forward through the replays, one capture per k; the mesh
               (cuda:0, cuda:0) likewise; two back-to-back
               predict_many_device results, each its own, and an unseen k's
               warm-up result beside a k = 1 replay; Trainer.evaluate
               graphed against eager for `unet` and `parallel_head_gate`
               (float32, 128², a ragged last batch) in every batch's counts
               and in the metrics, after a fit step and after a restore;
               bf16, float16 and int8 graphed against eager (argmax
               agreement >= 0.999, launches as eager's, the int8 conv
               kernel's 25 per forward among them) and the 0.995 / 0.99
               floors; a BatchServer flood of 1,280 equal to the eager
               server's with no capture after warmup (nor in two more floods
               and 10 lone requests), and a server without warm-up capturing
               in its worker; Trainer.evaluate over the synthetic test split
               at 304², graphed equal to eager;
 15. int8 kernel - the CUDA C++ int8 conv kernel at the exact inputs of the
               int8 Predictor's sites: every `int8_conv_nhwc` call of one
               eager forward (scope decoder and scope all at B = 32, the
               bench's Predictor at B = 256) held to the plain version bit
               for bit; per decoder depth at B = 32 and 256 the kernel's,
               the plain version's and cuDNN's bf16 conv's median times (L2
               flushed; cuDNN a yardstick for another function) beside the
               bound (int8 operations at 1,979 TOP/s, bytes at 3.35 TB/s);
               the graphed int8 Predictor's whole forward (scope decoder
               and all) against a twin whose sites run the plain version,
               bit for bit; at B = 256 the six depth 2-4 sites on the wide
               halo path; the crossover table (`int8_crossover`).
 16. bn_act  - the fused batch norm, residual join and ReLU kernel at every
               site of the served model's 304² forward (82 calls of
               `ops.norm.bn_act`), in bf16 at B = 32 and B = 256: each site
               on random inputs held to the plain chain (addcmul, add,
               relu) bit for bit, the kernel's and the plain chain's median
               times (L2 flushed) beside the byte bound at 3.35 TB/s,
               summed over the forward.
Every launch count of phases 4 and 6-14 includes the fused batch norm's:
BN_SITES (82) per folded eval forward of the served model, whichever
Predictor, graph or server runs it, and 0 in training and unfolded eval.
Exits non-zero, before printing any result, without CUDA or outside a
checkout of the repository; any failed check
raises. The last three lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
DEPTHS = [(304, 304, 32), (152, 152, 64), (76, 76, 256), (38, 38, 512), (19, 19, 1024)]
SERVE_B = 32
BENCH_B, BENCH_K = 256, 4  # octave_tpu_torch/bench.py's batch and dispatch depth
# (dtype, batch) of the kernel comparisons; the JSON line reports the last
CASES = [("float32", 8), ("bfloat16", 8), ("float16", 8), ("bfloat16", SERVE_B)]
K = 2
# bf16 serving paths among themselves (fused vs AAG kernel, predict_many vs
# __call__, mask_u8 vs prob_f32)
PATH_AGREEMENT_FLOOR = 0.999
# bf16 serving mask vs the plain float32 path: bf16 probabilities carry 8
# mantissa bits, so pixels within ~2^-8 of the 0.5 cut flip. The JAX
# package's own bf16 path agrees with its float32 path on ~0.997 of phantom
# pixels (tests/test_torch_unet.py::test_bf16_mask_agreement_matches_jax).
MASK_AGREEMENT_FLOOR = 0.995


def log(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def launches_of(want):
    """`want`, a {kernel: launches} expectation, with every registered
    kernel it leaves out at 0: `launch_counts()` reports the Triton kernels'
    and the int8 conv kernel's counts side by side."""
    return {"aag": 0, "bn_act": 0, "decoder_epilogue": 0, "int8_conv": 0, **want}


# launches of the fused batch norm (`ops.norm.bn_act`) in one folded eval
# forward on the card: the served ResnestUNet's, with the fused decoder or
# the AAG kernel, and the gated dual decoders' (phase 7); none in training
# or unfolded eval
BN_SITES = 82
BN_SITES_DUAL = 88


class Timer:
    """Median device time of fn() over `reps` launches, each after an L2
    flush; a spin kernel queued before each launch keeps the host's launch
    latency out of the measured interval."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps=15, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)  # about a millisecond of GPU time
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def kernel_inputs(torch, name, shape, dtype, gen):
    b, h, w, c = shape
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    wk = (rn(c, K) * 0.1).contiguous()
    bk = rn(K) * 0.1
    if name == "aag":
        return (rn(b, h, w, c).to(dtype), wk, bk)
    rs = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
    rb = torch.rand(c, generator=gen, device=dev) * 2 - 1
    return (rn(b, h, w, 2 * c).to(dtype), rn(b, 2 * c), rn(b, h, w, c).to(dtype), rs, rb, wk, bk)


def bound(name, shape, itemsize):
    """(bound_ms, bound_by, bytes): each input read once, each output written once."""
    b, h, w, c = shape
    n = b * h * w
    if name == "aag":
        nbytes = n * c * itemsize + (c * K + K) * 4 + n * (c + K) * itemsize
        ops = n * (2 * K + 1) * c
    else:
        nbytes = (n * 3 * c * itemsize + b * 2 * c * 4 + (2 * c + c * K + K) * 4
                  + n * (c + K) * itemsize)
        ops = n * (8 + 2 * K) * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes", nbytes) if t_bytes >= t_ops else (t_ops, "operations", nbytes)


@contextlib.contextmanager
def package_log():
    """The messages the port's logger emits inside the block, as a list."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("octave_tpu_torch")
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def run_cli(argv):
    """octave_tpu_torch.cli.main(argv) in process -> (its stdout, the
    package's log messages)."""
    from octave_tpu_torch import cli

    out = io.StringIO()
    with package_log() as records, contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return out.getvalue(), records


def printed_metrics(text):
    """The metrics dict a `cli train` / `cli eval` printed last."""
    import ast

    return ast.literal_eval([line for line in text.splitlines() if line.startswith("{")][-1])


def leaves(obj, path=""):
    """(path, leaf) of every tensor and scalar in a nested state."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, obj


def phantoms(n, hw, seed):
    """Vessel-like uint8 test images (n, hw, hw, 3): smooth curved bright
    tubes on gamma speckle, the statistics of an en-face angiogram."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.empty((n, hw, hw), np.uint8)
    for i in range(n):
        vessel = np.zeros((hw, hw), bool)
        for _ in range(rng.integers(6, 14)):
            x0, xm, x1 = rng.uniform(0, hw, 3)
            t = np.linspace(0, 1, 2 * hw)
            px = (1 - t) ** 2 * x0 + 2 * (1 - t) * t * xm + t**2 * x1
            py = t * (hw - 1)
            r = rng.uniform(1.0, 3.5)
            for cx, cy in zip(px[::4], py[::4]):
                y0, x0_ = max(int(cy - r), 0), max(int(cx - r), 0)
                yy, xx = np.mgrid[y0:min(int(cy + r) + 2, hw), x0_:min(int(cx + r) + 2, hw)]
                vessel[yy, xx] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img = rng.gamma(2.0, 0.12, (hw, hw)) + vessel * rng.uniform(0.35, 0.6)
        out[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.repeat(out[..., None], 3, axis=-1)


def main() -> int:
    # cuBLAS's deterministic workspace setting (phase 13 runs with
    # deterministic algorithms), read when cuBLAS first runs; on an H100 it
    # is PyTorch's default size anyway
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not (os.path.isdir(os.path.join(HERE, "octave_tpu_torch"))
            and os.path.isfile(os.path.join(HERE, "tests", "goldens.py"))):
        print(f"chip_smoke: {HERE} is not a checkout of the repository "
              "(octave_tpu_torch/ and tests/goldens.py are missing)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import numpy as np

    from goldens import fill_state_dict, input_array, load_fixture
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.ops.kernels import BUILD_DIR, cuda_build, kernel_tolerance, triton_build_dir
    from octave_tpu_torch.ops.kernels.aag import fused_aag, fused_aag_plain
    from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act
    from octave_tpu_torch.ops.kernels.decoder_epilogue import (
        fused_decoder_epilogue,
        fused_decoder_epilogue_plain,
    )
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.utils.checkpoint import load_weights_npz
    from octave_tpu_torch.utils.convert import from_jax_variables, load_reference_state_dict

    t_start = time.time()
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {card} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernels = {
        "aag": dict(fn=fused_aag, plain=fused_aag_plain,
                    source="octave_tpu_torch/ops/kernels/triton_aag.py",
                    replaces="octave_tpu/ops/pallas/aag.py:97"),
        "decoder_epilogue": dict(fn=fused_decoder_epilogue, plain=fused_decoder_epilogue_plain,
                                 source="octave_tpu_torch/ops/kernels/triton_decoder_epilogue.py",
                                 replaces="octave_tpu/ops/pallas/decoder_epilogue.py:131"),
    }
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
    gen = torch.Generator(device="cuda").manual_seed(0)

    # -- 1. build ---------------------------------------------------------
    # the CUDA C++ kernel: one nvcc per source under csrc/, started
    # together, then linked (build/cuda, emptied first); nvcc runs while
    # Triton compiles its kernels (build/triton, emptied first)
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    shutil.rmtree(BUILD_DIR, ignore_errors=True)
    built = {}

    def build_cuda():
        t0 = time.time()
        try:
            cuda_build.load()
        except RuntimeError as e:
            built["error"] = e
        built["s"] = time.time() - t0

    nvcc_thread = threading.Thread(target=build_cuda)
    nvcc_thread.start()
    triton_build_dir()
    for name, kern in kernels.items():
        t0 = time.time()
        for dt in dtypes.values():
            for _, _, c in DEPTHS:
                args = kernel_inputs(torch, name, (1, 4, 4, c), dt, gen)
                kern["fn"](*args)
        torch.cuda.synchronize()
        log(f"[build] {name}: {len(DEPTHS) * len(dtypes)} variants built in "
            f"{time.time() - t0:.1f} s into {BUILD_DIR}")
    check(any(BUILD_DIR.rglob("*.cubin")), f"no compiled kernels under {BUILD_DIR}")
    nvcc_thread.join()
    if "error" in built:
        raise built["error"]
    log(f"[build] int8_conv (CUDA C++): {len(cuda_build.sources())} sources compiled in "
        f"parallel and linked in {built['s']:.1f} s into {cuda_build.library_path()} "
        f"(nvcc {' '.join(cuda_build.ARCH + cuda_build.FLAGS)})")
    entry = None
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry function" in line:
            # the mangled template arguments: dtype, (vec,) tile
            found = re.search(r"(int8_conv(?:_halo)?_kernel)I(.*?)EEEv", line)
            entry = found and f"{found.group(1)}<{found.group(2)}>"
        elif entry and "Used" in line and "registers" in line:
            log(f"[build]   {entry}: {line.split(':', 1)[1].strip()}")
        elif entry and "spill" in line:
            log(f"[build]   {entry}: {line.strip()}")
    check(cuda_build.library_path().is_file(), "no CUDA kernel library was built")

    # -- 2. kernels against their plain versions ---------------------------
    timer = Timer(torch)
    totals = {(n, case): dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0, by=set())
              for n in kernels for case in CASES}

    def hold(name, shape, dt):
        """One kernel at one shape against its plain version: (max errors,
        kernel ms, plain ms, bound ms, bound_by, bytes), logged."""
        kern = kernels[name]
        args = kernel_inputs(torch, name, shape, dt, gen)
        out, yhat = kern["fn"](*args)
        torch.cuda.synchronize()
        ref_out, ref_yhat = kern["plain"](*args)
        errs = []
        for got, want, (atol, rtol) in zip((out, yhat), (ref_out, ref_yhat),
                                           kernel_tolerance(name, dt, shape[3])):
            d = (got.float() - want.float()).abs()
            lim = atol + rtol * want.float().abs()
            check(bool(torch.isfinite(got).all()), f"{name} {dt} {shape}: non-finite")
            check(bool((d <= lim).all()), f"{name} {dt} {shape}: max err "
                  f"{d.max().item():.3g} over atol {atol} rtol {rtol}")
            errs.append(d.max().item())
            del d, lim
        del out, yhat, ref_out, ref_yhat
        ms = timer.ms(lambda: kern["fn"](*args))
        plain_ms = timer.ms(lambda: kern["plain"](*args), reps=5)
        b_ms, b_by, nbytes = bound(name, shape, dt.itemsize)
        log(f"[kernels] {name} {str(dt)[6:]} {shape}: max|err| out {errs[0]:.3g} "
            f"y_hat {errs[1]:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB, "
            f"{nbytes / ms / 1e6:.0f} GB/s achieved)")
        return errs, ms, plain_ms, b_ms, b_by, nbytes

    def add(t, errs, ms, plain_ms, b_ms, b_by, nbytes):
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["bound_ms"] += b_ms
        t["bytes"] += nbytes
        t["by"].add(b_by)
        t["err"] = max(t["err"], *errs)

    for name in kernels:
        for dname, bsz in CASES:
            for hwc in DEPTHS:
                # the JSON line takes CASES[-1]'s totals
                add(totals[(name, (dname, bsz))], *hold(name, (bsz, *hwc), dtypes[dname]))
    for (name, (dname, bsz)), t in totals.items():
        log(f"[kernels] {name} {dname}, five depths, B={bsz}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.1%} of bound)")
    # the decoder epilogue at the bench's batch (phase 12: B = 256, bf16): at
    # depth 0 its z holds 256 * 304^2 * 64 = 1.51e9 elements, 70% of 2^31
    bench_totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0, by=set())
    for hwc in DEPTHS:
        add(bench_totals, *hold("decoder_epilogue", (BENCH_B, *hwc), torch.bfloat16))
    t = bench_totals
    log(f"[kernels] decoder_epilogue bfloat16, five depths, B={BENCH_B}: kernel {t['ms']:.4f} "
        f"ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_ms'] / t['ms']:.1%} of bound)")
    totals = {name: totals[(name, CASES[-1])] for name in kernels}
    torch.cuda.empty_cache()

    # -- 3. reference parity at 304² in float32 -----------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    manifest, meta, golden = load_fixture("unet304")
    sd = fill_state_dict(manifest)
    x = torch.from_numpy(input_array(meta["seed"], (1, 3, 304, 304))).permute(0, 2, 3, 1)
    x = x.contiguous().cuda()
    for fused, kern_name in ((True, "decoder_epilogue"), (False, "aag")):
        model = ResnestUNet(2, gating_level=meta["gating_level"], use_fused_decoder=fused)
        load_reference_state_dict(model, sd)
        model = model.cuda().to(memory_format=torch.channels_last).eval()
        fused_aag.launches = fused_decoder_epilogue.launches = 0
        with torch.inference_mode():
            atts, pred = model.predict(x)
        torch.cuda.synchronize()
        counts = {"aag": fused_aag.launches, "decoder_epilogue": fused_decoder_epilogue.launches}
        check(counts[kern_name] == 5 and sum(counts.values()) == 5,
              f"golden fused={fused}: launches {counts}, expected 5 of {kern_name}")
        errs = [float((a.permute(0, 3, 1, 2).cpu() - torch.from_numpy(golden[f"att{i}"]))
                      .abs().max()) for i, a in enumerate(atts)]
        errs.append(float((pred.permute(0, 3, 1, 2).cpu() - torch.from_numpy(golden["pred"]))
                          .abs().max()))
        log(f"[golden] unet304 fp32 via {kern_name}: launches {counts}; max|err| "
            f"att0-4 {', '.join(f'{e:.2e}' for e in errs[:5])}, pred {errs[5]:.2e}")
        check(len(atts) == 5 and max(errs) < 1e-3, f"golden parity failed via {kern_name}")
        del model, atts, pred
    torch.backends.cudnn.allow_tf32 = True  # back to the library default for serving

    # -- 4. serving on the trained weights ----------------------------------
    weights = from_jax_variables(load_weights_npz(os.path.join(HERE, "benchmarks",
                                                               "weights304.npz")))
    images = phantoms(SERVE_B, 304, seed=11)
    stack = np.broadcast_to(images[None], (4, *images.shape)).copy()
    serve = Predictor(weights)  # bf16, folded BN, fused epilogue, prob_f32, cuda
    serve_mask = Predictor(weights, output_format="mask_u8")
    serve_aag = Predictor(weights, use_fused_decoder=False)

    def counted(label, fn, want):
        """fn() with the launch counts zeroed just before it and read just after."""
        fused_aag.launches = fused_decoder_epilogue.launches = fused_bn_act.launches = 0
        result = fn()
        torch.cuda.synchronize()
        got = {"aag": fused_aag.launches, "decoder_epilogue": fused_decoder_epilogue.launches,
               "bn_act": fused_bn_act.launches}
        log(f"[serve] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        return result, got

    # __call__ is the main path; each kernel's JSON count is that of the
    # serving path it belongs to (the AAG kernel's: use_fused_decoder=False)
    probs, main_launches = counted("__call__ (main path)", lambda: serve(images),
                                   {"aag": 0, "decoder_epilogue": 5, "bn_act": BN_SITES})
    many, _ = counted("predict_many k=4", lambda: serve.predict_many(stack),
                      {"aag": 0, "decoder_epilogue": 20, "bn_act": 4 * BN_SITES})
    mask, _ = counted("mask_u8", lambda: serve_mask(images),
                      {"aag": 0, "decoder_epilogue": 5, "bn_act": BN_SITES})
    probs_aag, aag_launches = counted("use_fused_decoder=False", lambda: serve_aag(images),
                                      {"aag": 5, "decoder_epilogue": 0, "bn_act": BN_SITES})
    launches = {"decoder_epilogue": main_launches["decoder_epilogue"],
                "aag": aag_launches["aag"]}

    check(probs.shape == (SERVE_B, 304, 304, 2) and probs.dtype == np.float32, "probs shape")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    sum_err = float(np.abs(probs.sum(-1) - 1).max())
    check(sum_err <= 2**-7, f"probabilities sum to 1 within {sum_err}")  # two bf16 roundings
    check(mask.shape == (SERVE_B, 304, 304) and mask.dtype == np.uint8, "mask shape")
    agree_mask = float((mask == np.where(probs[..., 1] >= 0.5, 255, 0)).mean())
    agree_many = float((many.argmax(-1) == probs[None].argmax(-1)).mean())
    agree_aag = float((probs_aag.argmax(-1) == probs.argmax(-1)).mean())
    n_ref = 8
    plain = Predictor(weights, dtype=torch.float32, output_format="mask_u8", device="cpu")
    ref_mask = plain(images[:n_ref])
    agree_ref = float((ref_mask == mask[:n_ref]).mean())
    log(f"[serve] bf16 checks: finite, |sum-1| max {sum_err:.3g}, vessel share "
        f"{(mask > 0).mean():.4f}; agreement mask_u8/prob_f32 {agree_mask:.6f}, "
        f"argmax predict_many/call {agree_many:.6f}, "
        f"aag/fused {agree_aag:.6f}; mask_u8 vs plain fp32 path on CPU ({n_ref} images): "
        f"{agree_ref:.6f} (floor {MASK_AGREEMENT_FLOOR})")
    check(min(agree_mask, agree_many, agree_aag) >= PATH_AGREEMENT_FLOOR,
          "bf16 serving paths disagree")
    check(agree_ref >= MASK_AGREEMENT_FLOOR, f"mask agreement {agree_ref} < floor")

    # -- 5. training -------------------------------------------------------
    phase_train(torch, fused_aag, fused_aag_plain, fused_decoder_epilogue, kernel_tolerance)

    # -- 6. deployment -----------------------------------------------------
    del serve_mask, serve_aag, plain, probs, many, mask, probs_aag, stack
    release(torch)
    by_path = {"aag": {"serve, use_fused_decoder=False": aag_launches["aag"]},
               "decoder_epilogue": {"serve, __call__": main_launches["decoder_epilogue"]},
               "int8_conv": {}, "bn_act": {"serve, __call__": main_launches["bn_act"]}}
    deploy_tmp = tempfile.mkdtemp(prefix="octave_deploy_")  # phase 9 reads it too
    try:
        deploy, predict_args = phase_deploy(torch, serve, weights, deploy_tmp)
        for name, paths in deploy.items():
            by_path[name].update(paths)

        # -- 7. the rest of the model family ---------------------------------
        release(torch)
        for name, paths in phase_family(torch).items():
            by_path[name].update(paths)

        # -- 8. the native loader and data parallelism ------------------------
        release(torch)
        for name, paths in phase_parallel(torch).items():
            by_path[name].update(paths)

        # -- 9. int8 post-training quantised serving --------------------------
        release(torch)
        for name, paths in phase_int8(torch, smi, serve, weights, images,
                                      predict_args, deploy_tmp).items():
            by_path[name].update(paths)
    finally:
        shutil.rmtree(deploy_tmp, ignore_errors=True)

    # -- 10. the memory and lowering switches -------------------------------
    release(torch)
    for name, paths in phase_switches(torch, smi, weights, images, serve).items():
        by_path[name].update(paths)

    # -- 11. the rest of the surface: float16, the fan-out, ConvTranspose ----
    release(torch)
    for name, paths in phase_surface(torch, smi, weights, images, serve).items():
        by_path[name].update(paths)

    # -- 12. cli bench: the JAX package's headline serving configuration ----
    del serve
    release(torch)
    for name, paths in phase_bench(torch, smi).items():
        by_path[name].update(paths)

    # -- 13. the train step as one CUDA-graph replay per call ----------------
    release(torch)
    for name, paths in phase_graph(torch, smi).items():
        by_path[name].update(paths)

    # -- 14. serving and evaluation as CUDA-graph replays ---------------------
    release(torch)
    for name, paths in phase_graphed(torch, smi, weights, images).items():
        by_path[name].update(paths)

    # -- 15. the int8 conv kernel at the int8 Predictor's sites ---------------
    release(torch)
    int8_kernel = phase_int8_kernel(torch, smi, weights, images)

    line = {"kernels": [
        {"name": name, "route": "triton", "source": kern["source"],
         "replaces": kern["replaces"], "launches": launches[name],
         "launches_by_path": by_path[name],
         "max_abs_err": totals[name]["err"], "ms": totals[name]["ms"],
         "plain_ms": totals[name]["plain_ms"], "bound_ms": totals[name]["bound_ms"],
         "bound_by": "bytes" if totals[name]["by"] == {"bytes"} else "operations",
         "library_ms": None}
        for name, kern in kernels.items()]}
    # the int8 conv kernel: its main path is the int8 Predictor's __call__
    # (phase 9); its figures are phase 15's, summed over the 25 decoder
    # convs at B = SERVE_B (and at the bench's B = BENCH_B). No one PyTorch
    # call computes it (torch._int_mm is the GEMM alone): library_ms null;
    # cuDNN's bf16 conv of the same shapes is a yardstick of another function
    serve8, bench8 = int8_kernel["serve"][0], int8_kernel["bench"][0]

    def int8_row(t):
        return {"max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "yardstick_cudnn_bf16_ms": t["cudnn_bf16_ms"]}

    line["kernels"].append({
        "name": "int8_conv", "route": "cuda",
        "source": "octave_tpu_torch/ops/kernels/csrc/int8_conv.cu",
        "replaces": "octave_tpu/ops/quant.py:118 (int8_conv; XLA, not Pallas)",
        "launches": by_path["int8_conv"]["int8 __call__ (decoder, fused)"],
        "launches_by_path": by_path["int8_conv"], **int8_row(serve8), "library_ms": None,
        "at_bench_batch": {"batch": BENCH_B, "dtype": "bfloat16", **int8_row(bench8)}})
    # the epilogue at the bench's batch too (phase 2's B = 256 case)
    next(k for k in line["kernels"] if k["name"] == "decoder_epilogue")["at_bench_batch"] = {
        "batch": BENCH_B, "dtype": "bfloat16", "max_abs_err": bench_totals["err"],
        "ms": bench_totals["ms"], "plain_ms": bench_totals["plain_ms"],
        "bound_ms": bench_totals["bound_ms"],
        "bound_by": "bytes" if bench_totals["by"] == {"bytes"} else "operations"}
    release(torch)

    # -- 16. the fused batch norm, residual join and ReLU at the model's sites
    bn = phase_bn_act(torch, smi)

    def row(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes"}

    line["kernels"].append({
        "name": "bn_act", "route": "triton",
        "source": "octave_tpu_torch/ops/kernels/triton_bn_act.py",
        "replaces": None, "launches": by_path["bn_act"]["int8 __call__ (decoder, fused)"],
        "launches_by_path": by_path["bn_act"], "dtype": "bfloat16", "batch": SERVE_B,
        **row(bn["by_batch"][SERVE_B]), "library_ms": None,
        "at_bench_batch": {"batch": BENCH_B, "dtype": "bfloat16",
                           **row(bn["by_batch"][BENCH_B])}})
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


# train-phase bounds, card float32 (TF32 off) against CPU float32. Losses
# as the float32 port against float64 on the CPU; gradients as relative L2
# over each player's whole gradient: the segmentor's grows float32 rounding
# through BNs over few values (the split-attention BNs see B pooled values),
# on the CPU 1.7e-2 from float64 in the encoder at 304², B = 8.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_L2 = {"segmentor": 0.05, "critic": 1e-3}
BF16_LOSS_RTOL = 0.05
TRAIN_SHAPES = [(8, 304, 304, 32), (8, 152, 152, 64), (8, 76, 76, 256), (8, 38, 38, 512),
                (8, 19, 19, 1024)]


def aag_autocast_ref(x, w, b, cast):
    """The gate as the train step under autocast computes it, for a float64
    x, w, b: logits, y_hat and mask from x rounded to `cast`, and (x*mask,
    y_hat) differentiated as the kernel's backward does it, through x
    itself (g_x = g_out*mask + g_z W^T, g_w = x^T g_z); and the logits,
    whose `.grad` after the backward is g_z."""
    import torch
    shift = (x.detach().to(cast).double() - x.detach()) @ w.detach()  # what rounding x moves
    logits = x @ w + b + shift
    logits.retain_grad()
    yhat = torch.softmax(logits, dim=-1)
    return x * yhat[..., 1:].sum(dim=-1, keepdim=True), yhat, logits


def phase_train(torch, fused_aag, fused_aag_plain, fused_decoder_epilogue, kernel_tolerance):
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.config import Config

    n_data = 8  # synthetic phantoms per split: one batch of 8

    def trainer(device="cuda", **over):
        cfg = Config().apply_overrides({"data.synthetic_n": str(n_data), "train.eval_every": "0",
                                        "train.log_every": "0", **over})
        return Trainer(cfg, device=device)

    def batch_of(tr):
        host = next(ds.batch_iterator(build_dataset(tr.cfg), tr.cfg.data.batch_size, seed=0))
        return tr.device_batch(host)

    def counts():
        torch.cuda.synchronize()
        return {"aag": fused_aag.launches, "decoder_epilogue": fused_decoder_epilogue.launches}

    def zero():
        fused_aag.launches = fused_decoder_epilogue.launches = 0

    def finite(losses):
        return all(bool(torch.isfinite(v)) for v in losses.values())

    def fmt(losses):
        return ", ".join(f"{k} {float(v):.6f}" for k, v in losses.items())

    # 5a. the main path: Trainer.fit, then evaluate, default Config
    tr = trainer(**{"train.steps": "3"})
    zero()
    state = tr.fit()
    got = counts()
    log(f"[train] Trainer.fit, 3 steps, default Config (304², B=8, fp32, critic depth 4, "
        f"64 filters, noise on): launches {got}")
    check(state.step == 3 and got == {"aag": 15, "decoder_epilogue": 0},
          f"fit: launches {got}, expected 5 AAG launches per train step")
    zero()
    metrics = tr.evaluate(state)
    got = counts()
    log(f"[train] evaluate ({n_data} phantoms, 1 batch): launches {got}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(got == {"aag": 5, "decoder_epilogue": 0}, f"evaluate: launches {got}, expected 5")
    check(all(0.0 <= v <= 1.0 for v in metrics.values()), f"eval metrics out of range {metrics}")
    batch = batch_of(tr)
    zero()
    losses = tr.train_step(state, batch)
    got = counts()
    check(got["aag"] == 5 and finite(losses), f"one train step: launches {got}, losses {losses}")
    del tr, state, batch, losses

    # 5b. the AAG Function inside autograd at the train shapes: x in dt, and,
    # as the train step under autocast calls it, float32 x gated in the
    # autocast dtype (x*mask in that dtype, y_hat float32, the backward in
    # float32 from x itself). Gradient bounds: bf16's y_hat is kept in bf16
    # from forward to backward and g_w, g_b sum cancelling terms over every
    # pixel; under autocast the backward is float32 math on float32 values,
    # held to the float64 formula of the same function (`aag_autocast_ref`:
    # its y_hat from x rounded once), so float32's bound. There g_b, whose
    # two entries are opposite sums over every pixel that may cancel to near
    # zero, is held relative to the sum of its terms' magnitudes, the scale
    # that float32 summation error follows
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    cases = ((torch.float32, None, 1e-4), (torch.bfloat16, None, 2**-5),
             (torch.float32, torch.bfloat16, 1e-4), (torch.float32, torch.float16, 1e-4))
    for dt, cast, share in cases:
        label = str(dt)[6:] + (f" autocast {str(cast)[6:]}" if cast else "")
        for shape in TRAIN_SHAPES:
            c = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dt).requires_grad_()
            w = (torch.randn(c, 2, generator=gen, device="cuda") * 0.1).requires_grad_()
            b = (torch.randn(2, generator=gen, device="cuda") * 0.1).requires_grad_()
            g_out = torch.randn(shape, generator=gen, device="cuda").to(cast or dt)
            g_yhat = torch.randn(shape[:-1] + (2,), generator=gen,
                                 device="cuda").to(torch.float32 if cast else dt)
            out, yhat = fused_aag(x, w, b, cast)
            torch.autograd.backward((out, yhat), (g_out, g_yhat))
            ref = [t.detach().double().requires_grad_() for t in (x, w, b)]
            r_out, r_yhat, *r_z = (aag_autocast_ref(*ref, cast) if cast
                                   else fused_aag_plain(*ref))
            torch.autograd.backward((r_out, r_yhat), (g_out.double(), g_yhat.double()))
            (tol_o, tol_y) = kernel_tolerance("aag", dt, c)
            want_o, want_y = r_out.detach(), r_yhat.detach()
            if cast:
                check(out.dtype == cast and yhat.dtype == torch.float32,
                      f"AAG {label}: outputs {out.dtype} {yhat.dtype}")
                want_o, want_y = (t.double() for t in fused_aag_plain(
                    x.detach().to(cast), w.detach(), b.detach(), yhat_dtype=torch.float32))
                tol_o, tol_y = kernel_tolerance("aag", cast, c)[0], tol_y
            for got_t, want, (atol, rtol) in ((out, want_o, tol_o), (yhat, want_y, tol_y)):
                d = (got_t.double() - want).abs()
                check(bool((d <= atol + rtol * want.abs()).all()),
                      f"AAG forward {label} {shape}: max err {d.max().item():.3g}")
            check(x.grad.dtype == dt and w.grad.dtype == b.grad.dtype == torch.float32,
                  f"AAG grads dtypes {x.grad.dtype} {w.grad.dtype} {b.grad.dtype}")
            for name, got_g, want in (("g_x", x.grad, ref[0].grad), ("g_w", w.grad, ref[1].grad),
                                      ("g_b", b.grad, ref[2].grad)):
                scale = want.abs().max()
                if cast and name == "g_b":  # the float64 logits' gradient, summed as |.|
                    scale = r_z[0].grad.abs().reshape(-1, 2).sum(dim=0).max()
                err = float((got_g.double() - want).abs().max() / scale)
                worst[(label, name)] = max(worst.get((label, name), 0.0), err)
                check(err <= share, f"AAG {name} {label} {shape}: {err:.3g} of "
                      f"{float(scale):.4g} > {share}")
            del x, w, b, out, yhat, ref, r_out, r_yhat, r_z, g_out, g_yhat, want_o, want_y
    log("[train] AAG kernel forward + backward vs the float64 plain formula at the five "
        "train shapes (B=8; under autocast the forward vs the plain formula on x rounded, "
        "the backward vs aag_autocast_ref): worst |err| / max|grad| (g_b under autocast: / "
        "sum of |g_z|) " + ", ".join(f"{lb} {n} {e:.2e}" for (lb, n), e in worst.items()))

    # 5c. kernel against plain: one float32 step on the card and on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    quiet = {"model.instance_noise": "false", "model.label_noise": "false"}
    gpu, cpu = trainer(**quiet), trainer(device="cpu", **quiet)
    s_gpu, s_cpu = gpu.init_state(), cpu.init_state()
    zero()
    l_gpu = gpu.train_step(s_gpu, batch_of(gpu))
    got = counts()
    check(got["aag"] == 5, f"card fp32 step: launches {got}")
    l_cpu = cpu.train_step(s_cpu, batch_of(cpu))
    loss_err = max(abs(float(l_gpu[k]) / float(l_cpu[k]) - 1) for k in l_cpu)
    def rel_l2(pairs):
        return float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs))
                     / torch.sqrt(sum((b**2).sum() for _, b in pairs)))

    grad_err, by_module = {}, {}
    for player in ("segmentor", "critic"):
        pairs = [(n, p.grad.double().cpu(), q.grad.double()) for (n, p), q in
                 zip(getattr(s_gpu, player).named_parameters(),
                     getattr(s_cpu, player).parameters())]
        grad_err[player] = rel_l2([(a, b) for _, a, b in pairs])
        for top in dict.fromkeys(n.split(".")[0] for n, _, _ in pairs):
            by_module[top] = rel_l2([(a, b) for n, a, b in pairs if n.split(".")[0] == top])
    log("[train] fp32 step gradient rel L2 err by module (card vs CPU): "
        + ", ".join(f"{k} {v:.1e}" for k, v in by_module.items()))
    log(f"[train] fp32 step, 304², B=8, TF32 off, noise off: card (AAG kernel) {fmt(l_gpu)}; "
        f"CPU (plain AAG) {fmt(l_cpu)}; max loss rel err {loss_err:.2e} "
        f"(bound {TRAIN_LOSS_RTOL}); gradient rel L2 err segmentor "
        f"{grad_err['segmentor']:.2e} (bound {TRAIN_GRAD_L2['segmentor']}), critic "
        f"{grad_err['critic']:.2e} (bound {TRAIN_GRAD_L2['critic']})")
    check(loss_err <= TRAIN_LOSS_RTOL, f"card vs CPU losses differ by {loss_err}")
    for player, err in grad_err.items():
        check(err <= TRAIN_GRAD_L2[player], f"card vs CPU {player} gradients differ by {err}")
    del gpu, cpu, s_gpu, s_cpu, l_gpu, l_cpu

    # 5d. bf16 against float32 on the card, B=8, noise off
    f32, b16 = trainer(**{k: v for k, v in quiet.items() if k != "data.batch_size"}), \
        trainer(**{**{k: v for k, v in quiet.items() if k != "data.batch_size"},
                   "train.compute_dtype": "bfloat16"})
    l32 = f32.train_step(f32.init_state(), batch_of(f32))
    l16 = b16.train_step(b16.init_state(), batch_of(b16))
    bf16_err = {k: abs(float(l16[k]) / float(l32[k]) - 1) for k in l32}
    log(f"[train] bf16 vs fp32 step (TF32 off), 304², B=8, noise off: bf16 {fmt(l16)}; "
        f"relative differences " + ", ".join(f"{k} {v:.2e}" for k, v in bf16_err.items())
        + f" (bound {BF16_LOSS_RTOL})")
    check(max(bf16_err.values()) <= BF16_LOSS_RTOL, f"bf16 vs fp32 losses: {bf16_err}")
    del f32, b16, l32, l16
    torch.backends.cudnn.allow_tf32 = True  # torch's default again

    # 5e. 20 bf16 steps on one batch, default Config with bf16 (noise on)
    tr = trainer(**{"train.compute_dtype": "bfloat16"})
    state = tr.init_state()
    batch = batch_of(tr)
    keys = {"segmentor parameters": (state.segmentor, "fc.weight"),
            "critic parameters": (state.critic, "out.0.weight"),
            "BN running stats": (state.segmentor, "encoder_1.0.bn1.running_mean"),
            "spectral u/v": (state.critic, "spectral_dict.spectral_0.0.weight_u")}
    before = {k: m.state_dict()[n].clone() for k, (m, n) in keys.items()}
    history = [tr.train_step(state, batch) for _ in range(20)]
    sup = [float(h["loss_sup"]) for h in history]
    moved = {k: not torch.equal(before[k], m.state_dict()[n]) for k, (m, n) in keys.items()}
    log(f"[train] 20 bf16 steps on one batch (noise on): loss_sup {sup[0]:.5f} -> {sup[-1]:.5f}; "
        f"last {fmt(history[-1])}; state moved {moved}")
    check(all(finite(h) for h in history), "non-finite loss in the 20 bf16 steps")
    check(all(moved.values()), f"state did not move: {moved}")
    check(sup[-1] < sup[0], f"loss_sup did not fall: {sup[0]} -> {sup[-1]}")
    del tr, state, batch, history


# deploy-phase bounds. Probabilities of one image through the server and
# through Predictor.__call__ may differ by one bf16 rounding; the npz export
# rounds the raw weights to bf16 before the BN fold instead of after it.
SERVER_PROB_ATOL = 2**-7
SERVER_MASK_FLOOR = 0.9999
EXPORT_PROB_MEAN_ATOL = 0.02


def phase_deploy(torch, serve, weights, tmp):
    """Phase 6, in `tmp`, which phase 9 reads after it. Returns
    ({kernel: {path: launches}} of its main-path runs, the `cli predict`
    arguments of its PNG folder and checkpoint)."""
    return _deploy(torch, serve, weights, tmp)


def _deploy(torch, serve, weights, tmp):
    import numpy as np

    from octave_tpu_torch.data import augment
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import BatchServer, Predictor
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        export_weights_npz,
        load_weights_npz,
        state_to_dict,
    )
    from octave_tpu_torch.utils.config import Config
    from octave_tpu_torch.utils.imageio import read_image, write_png_gray

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}

    def counted(label, fn, want):
        """fn() with the launch counts zeroed just before it and read just after."""
        launch_counts(reset=True)
        result = fn()
        torch.cuda.synchronize()
        got, want = launch_counts(), launches_of(want)
        log(f"[deploy] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        for name, n in got.items():
            if n:
                paths[name][label] = n
        return result

    # 6.1 phantoms as PNGs in a ROSE tree, read back through rose()
    n_train, n_test = 32, 16
    root = os.path.join(tmp, "data")
    phantoms_ds = ds.SyntheticOcta((304, 304), n=n_train + n_test, seed=21)
    split_of = {"train": range(n_train), "test": range(n_train, n_train + n_test)}
    for split, idx in split_of.items():
        base = os.path.join(root, "ROSE-1", "SVC", split)
        for d in ("img", "gt", "thin_gt"):
            os.makedirs(os.path.join(base, d))
        for i in idx:
            s = phantoms_ds[i]
            write_png_gray(os.path.join(base, "img", f"{i:03d}.png"), s.image)
            write_png_gray(os.path.join(base, "gt", f"{i:03d}.png"), s.mask * 255)
            write_png_gray(os.path.join(base, "thin_gt", f"{i:03d}.png"),
                           (s.scribble == 2).astype(np.uint8) * 255)
    for split, idx in split_of.items():
        folder = ds.rose(root, "ROSE-1/SVC", split)
        check(len(folder) == len(idx), f"rose {split}: {len(folder)} samples")
        for j, i in enumerate(idx):
            got, want = folder[j], phantoms_ds[i]
            check(np.array_equal(got.image, want.image) and np.array_equal(got.mask, want.mask)
                  and np.array_equal(got.scribble, np.where(want.scribble == 2, 2, 0)),
                  f"rose {split} sample {j} differs from the phantom written")
    log(f"[deploy] {n_train} + {n_test} phantoms (304²) written as PNGs into a ROSE tree and "
        f"read back through rose(): pixels equal")

    # 6.2 cli train on the folder: augmentation, bf16, checkpoint, trace; resume
    ckpt_dir, prof_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "prof")
    over = {"data.dataset": "rose", "data.root": root, "data.augment": "true",
            "data.augment_intensity": "0.1", "data.batch_size": "8",
            "train.compute_dtype": "bfloat16", "train.checkpoint_dir": ckpt_dir,
            "train.checkpoint_every": "4", "train.eval_every": "0", "train.log_every": "1"}

    def argv(cmd, **extra):
        return [cmd] + [f"{k}={v}" for k, v in {**over, **extra}.items()]

    eval_batches = n_test // 8
    text, records = counted(
        "cli train, 4 steps + final evaluate",
        lambda: run_cli(argv("train", **{"train.steps": "4", "train.profile_dir": prof_dir})),
        {"aag": 5 * (4 + eval_batches), "decoder_epilogue": 0})
    check(CheckpointManager(ckpt_dir).all_steps() == [4], "no complete checkpoint at step 4")
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    check(len(traces) == 1 and os.path.getsize(os.path.join(prof_dir, traces[0])) > 10_000,
          f"no profiler trace in {prof_dir}: {traces}")
    trace_mb = os.path.getsize(os.path.join(prof_dir, traces[0])) / 1e6
    shutil.rmtree(prof_dir)
    check(not any("resumed" in r for r in records), "the first run resumed from something")
    steps_logged = [r for r in records if r.startswith("step ")]
    check(len(steps_logged) == 4, f"expected 4 logged steps, got {steps_logged}")
    log(f"[deploy] cli train data.dataset=rose data.augment=true bf16 B=8, 4 steps "
        f"(trace of {trace_mb:.1f} MB): {len(steps_logged)} steps logged; metrics "
        f"{printed_metrics(text)}")

    # the resumed run through the Trainer itself, to keep the live state
    cfg = Config().apply_overrides({**over, "train.steps": "6"})
    tr = Trainer(cfg, device="cuda")
    with package_log() as records:
        live = counted("Trainer.fit resumed, steps 5-6", tr.fit,
                       {"aag": 10, "decoder_epilogue": 0})
    check(any(r == "resumed from step 4" for r in records), f"no resume logged: {records[:5]}")
    check(live.step == 6 and CheckpointManager(ckpt_dir).all_steps() == [4, 6],
          f"resumed run ended at step {live.step}")

    # a checkpoint of the live state, and the exact restore
    save_dir = os.path.join(tmp, "ckpt_live")
    mgr = CheckpointManager(save_dir)
    check(mgr.save(live.step, live), "save refused")
    mgr.wait()
    ckpt_bytes = os.path.getsize(os.path.join(save_dir, f"step_{live.step:08d}", "state.pt"))
    fresh = tr.init_state()
    restored = mgr.restore_latest(fresh)
    mgr.close()
    shutil.rmtree(save_dir)
    want, got = dict(leaves(state_to_dict(live))), dict(leaves(state_to_dict(restored)))
    check(want.keys() == got.keys(), "restored state has other entries than the live one")
    n_tensors = 0
    for k, v in want.items():
        if torch.is_tensor(v):
            n_tensors += 1
            check(v.device == got[k].device and v.dtype == got[k].dtype
                  and v.stride() == got[k].stride() and torch.equal(v, got[k]),
                  f"restored {k} differs from the live state")
        else:
            check(v == got[k], f"restored {k}: {got[k]} != {v}")
    log(f"[deploy] resumed from step 4 to step 6; checkpoint of the 304² state "
        f"{ckpt_bytes / 1e9:.3f} GB, restored into a fresh state: restored == live in all "
        f"{n_tensors} tensors, counters, generator and step")

    # 6.3 cli eval --checkpoint against the live state's metrics
    live_metrics = counted("Trainer.evaluate, live state", lambda: tr.evaluate(live),
                           {"aag": 5 * eval_batches, "decoder_epilogue": 0})
    restored_metrics = tr.evaluate(restored)
    text, _ = counted("cli eval --checkpoint",
                      lambda: run_cli(["eval", "--checkpoint", ckpt_dir] + argv("x")[1:]),
                      {"aag": 5 * eval_batches, "decoder_epilogue": 0})
    cli_metrics = printed_metrics(text)
    for k, v in live_metrics.items():
        check(abs(restored_metrics[k] - v) <= 1e-6, f"restored evaluate {k}: "
              f"{restored_metrics[k]} vs live {v}")
        # the command prints 4 decimals
        check(abs(cli_metrics[k] - v) <= 5e-5 + 1e-6, f"cli eval {k}: {cli_metrics[k]} vs {v}")
    log(f"[deploy] cli eval --checkpoint prints {cli_metrics}; live state "
        + ", ".join(f"{k} {v:.6f}" for k, v in live_metrics.items())
        + "; restored state's evaluate within 1e-6")

    # an augmented batch (D4 + jitter) on the card
    host = next(ds.batch_iterator(build_dataset(cfg), 8, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = tr.device_batch(host, augment.draw(gen, 8, 0.1))
    check(all(t.is_contiguous() for t in (batch["image"], batch["scribble_onehot"],
                                          batch["mask_onehot"])), "augmented batch not contiguous")
    seg_sd = {k: v.detach().clone() for k, v in restored.segmentor.state_dict().items()}
    del tr, live, restored, fresh, batch, want, got
    torch.cuda.empty_cache()

    # 6.4 export to the compact npz, read back; cli predict over the test PNGs
    npz = os.path.join(tmp, "weights.npz")
    export_weights_npz(npz, seg_sd, max_bytes=90 * 10**6)
    shards = sorted(f for f in os.listdir(tmp) if f.startswith("weights-shard"))
    loaded = load_weights_npz(npz)
    check(loaded.keys() == seg_sd.keys(), "exported npz has other keys than the state dict")
    for k, v in seg_sd.items():
        ref = v.bfloat16().float().cpu().numpy() if v.dtype == torch.float32 else v.cpu().numpy()
        check(loaded[k].dtype == ref.dtype and np.array_equal(loaded[k], ref),
              f"exported {k} is not the bf16 rounding of the state")
    npz_mb = sum(os.path.getsize(os.path.join(tmp, f)) for f in shards) / 1e6
    log(f"[deploy] export_weights_npz -> {len(shards)} shards, {npz_mb:.1f} MB; load_weights_npz "
        f"gives every tensor's bf16 rounding")

    test_dir = os.path.join(root, "ROSE-1", "SVC", "test", "img")
    out_dir = os.path.join(tmp, "pred")
    predict_args = ["--images", test_dir, "--checkpoint", ckpt_dir] + argv("x")[1:]
    text, _ = counted(
        "cli predict, 16 images in 2 batches",
        lambda: run_cli(["predict", "--out", out_dir] + predict_args),
        {"aag": 0, "decoder_epilogue": 10, "bn_act": 2 * BN_SITES})
    names = sorted(os.listdir(out_dir))
    check(len(names) == 2 * n_test and sum(n.endswith("_prob.npy") for n in names) == n_test
          and sum(n.endswith("_mask.png") for n in names) == n_test, f"predict wrote {names}")
    files = sorted(os.path.join(test_dir, f) for f in os.listdir(test_dir))
    gray = ds.load_image_batch(files, (304, 304))
    x = np.repeat((gray.astype(np.float32) / 255.0)[..., None], 3, axis=-1)
    direct = Predictor(seg_sd)
    direct_probs = np.concatenate([direct(x[:8]), direct(x[8:])])[..., 1]
    exported = Predictor(loaded)
    exported_probs = np.concatenate([exported(x[:8]), exported(x[8:])])[..., 1]
    cli_probs = np.stack([np.load(os.path.join(out_dir, os.path.basename(f)[:-4] + "_prob.npy"))
                          for f in files])
    cli_masks = np.stack([read_image(os.path.join(out_dir, os.path.basename(f)[:-4]
                                                  + "_mask.png")) for f in files])
    direct_masks = np.where(direct_probs >= 0.5, 255, 0)
    agree = float((cli_masks == direct_masks).mean())
    prob_err = float(np.abs(cli_probs - direct_probs).max())
    export_err = float(np.abs(exported_probs - direct_probs).mean())
    export_agree = float(((exported_probs >= 0.5) == (direct_probs >= 0.5)).mean())
    log(f"[deploy] cli predict wrote {n_test} .npy and {n_test} masks; masks vs Predictor called "
        f"directly: {agree:.6f} equal (exactly equal: {agree == 1.0}), max |prob diff| "
        f"{prob_err:.3g}; vessel share {float((cli_masks > 0).mean()):.4f}; Predictor on the "
        f"exported npz vs on the state: mean |prob diff| {export_err:.4f} "
        f"(bound {EXPORT_PROB_MEAN_ATOL}), mask agreement {export_agree:.4f}")
    check(bool(np.isfinite(cli_probs).all()), "non-finite predictions")
    check(agree >= SERVER_MASK_FLOOR and prob_err <= SERVER_PROB_ATOL,
          "cli predict differs from the Predictor called directly")
    check(export_err <= EXPORT_PROB_MEAN_ATOL, "the exported weights predict differently")
    del direct, exported, loaded, seg_sd
    torch.cuda.empty_cache()

    # 6.5 BatchServer on the committed trained weights
    n_flood = 300
    base = phantoms(64, 304, seed=12)
    images = [np.roll(base[i % 64], i, axis=1) for i in range(n_flood)]  # all distinct
    padded = np.zeros((-(-n_flood // SERVE_B) * SERVE_B, 304, 304, 3), np.uint8)
    padded[:n_flood] = np.stack(images)
    ref_probs = np.concatenate([serve(padded[i:i + SERVE_B])
                                for i in range(0, len(padded), SERVE_B)])[:n_flood]

    dispatched = []
    inject = {"oom_at_k": None}
    dispatch = serve.predict_many_device

    def recording(stack):
        if stack.shape[0] == inject["oom_at_k"]:
            raise torch.OutOfMemoryError(f"injected at k = {stack.shape[0]}")
        dispatched.append(stack.shape[0])
        return dispatch(stack)

    serve.predict_many_device = recording  # the server's only way to the device
    try:
        srv = BatchServer(serve, batch=SERVE_B, image_hw=(304, 304), ks=(1, 2, 4),
                          pipeline_depth=2)  # warms up at (32, 304², uint8)
        check(srv.ks == (1, 2, 4), f"server dropped depths upfront: {srv.ks}")

        def flood():
            return list(srv.map(iter(images)))

        def check_flood(outs, label):
            check(len(outs) == n_flood and all(o.shape == (304, 304, 2) for o in outs),
                  f"{label}: {len(outs)} results")
            got = np.stack(outs)
            err = float(np.abs(got - ref_probs).max())
            agree = float(((got[..., 1] >= 0.5) == (ref_probs[..., 1] >= 0.5)).mean())
            check(bool(np.isfinite(got).all()), f"{label}: non-finite results")
            check(err <= SERVER_PROB_ATOL and agree >= SERVER_MASK_FLOOR,
                  f"{label}: max |prob diff| {err}, mask agreement {agree}")
            return err, agree

        flood()  # warm: pinned download buffers of every k
        dispatched.clear()
        launch_counts(reset=True)
        outs = flood()
        torch.cuda.synchronize()
        got_counts = launch_counts()
        want_counts = launches_of({"decoder_epilogue": 5 * sum(dispatched),
                                   "bn_act": BN_SITES * sum(dispatched)})
        log(f"[deploy] BatchServer flood of {n_flood}: dispatched k {dispatched}; launches "
            f"{got_counts} (expected {want_counts})")
        check(got_counts == want_counts, "flood: launches are not 5 (epilogue) and "
              f"{BN_SITES} (fused batch norm) x the sum of the k")
        check(sum(dispatched) * SERVE_B >= n_flood and any(k > 1 for k in dispatched),
              f"no dispatch took k > 1 under the flood: {dispatched}")
        for name in ("decoder_epilogue", "bn_act"):
            paths[name]["BatchServer flood of 300"] = got_counts[name]
        err, agree = check_flood(outs, "flood")

        n_long = 40 * SERVE_B  # a longer flood, from a generator
        n_out = sum(1 for _ in srv.map(images[i % n_flood] for i in range(n_long)))
        check(n_out == n_long, f"long flood returned {n_out} of {n_long}")

        dispatched.clear()
        for img in images[:10]:
            srv.submit(img).result(timeout=120)
        check(dispatched == [1] * 10, f"lone requests took k {dispatched}")
        log(f"[deploy] BatchServer 304² bf16 trained weights, B={SERVE_B}, ks (1,2,4), depth 2, "
            f"uint8 in, prob_f32 out: flood of {n_flood} in order, max |prob diff| {err:.3g} vs "
            f"__call__, mask agreement {agree:.6f}; flood of {n_long} all returned; 10 lone "
            f"requests each k=1")

        # an out-of-memory at k = 4: the depth is dropped, every request resolves
        inject["oom_at_k"] = 4
        dispatched.clear()
        outs = flood()
        check(srv._ks_live == (1, 2), f"after the injected OOM _ks_live is {srv._ks_live}")
        check(all(k < 4 for k in dispatched), f"k = 4 dispatched after its OOM: {dispatched}")
        check_flood(outs, "flood after the injected OOM")
        log(f"[deploy] injected torch.OutOfMemoryError at k = 4: _ks_live {srv._ks_live}, all "
            f"{n_flood} futures resolved and correct, dispatched k {dispatched}")
        srv.close()
    finally:
        del serve.predict_many_device

    # the mask_u8 wire format through the server
    serve_mask = Predictor(weights, output_format="mask_u8")
    with BatchServer(serve_mask, batch=SERVE_B, image_hw=(304, 304), ks=(1, 2, 4)) as srv:
        masks = np.stack(list(srv.map(iter(images[:70]))))
    want = np.concatenate([serve_mask(padded[i:i + SERVE_B]) for i in (0, 32, 64)])[:70]
    agree = float((masks == want).mean())
    log(f"[deploy] BatchServer mask_u8, 70 images: {agree:.6f} of pixels equal to __call__")
    check(masks.dtype == np.uint8 and agree >= SERVER_MASK_FLOOR, "mask_u8 through the server")
    return paths, predict_args


# phase 7: the rest of the model family. The card-vs-CPU step takes phase 5's
# bounds, the critic bound for each critic; fused against unfused dual
# decoders takes PATH_AGREEMENT_FLOOR.
FAMILY_HW = 304
FAMILY_STEP_HW, FAMILY_STEP_B = 112, 2


def phase_family(torch, device="cuda"):
    """Phase 7. Returns {kernel: {path: launches}} of its runs."""
    tmp = tempfile.mkdtemp(prefix="octave_family_")
    try:
        return _family(torch, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _family(torch, device, tmp):
    import numpy as np

    from goldens import fill_state_dict, input_array, load_fixture
    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.models.octa import octa_scribble_net
    from octave_tpu_torch.models.segmentor import (
        ResnestUnetParallelHead,
        ResnestUnetParallelHeadAttentionGate,
    )
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.ops.norm import fold_batch_stats, folded_inference
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict
    from octave_tpu_torch.utils.config import Config
    from octave_tpu_torch.utils.convert import load_reference_state_dict
    from octave_tpu_torch.utils.imageio import write_png_gray

    hw = FAMILY_HW
    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}

    def counted(label, fn, want):
        """fn() with the launch counts zeroed just before it and read just after."""
        launch_counts(reset=True)
        result = fn()
        torch.cuda.synchronize()
        got, want = launch_counts(), launches_of(want)
        log(f"[family] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        for name, n in got.items():
            if n:
                paths[name][label] = n
        return result

    def max_err(a, b):
        return float((a.detach().float().cpu() - torch.as_tensor(b)).abs().max())

    # 7.1 the dual decoders' goldens in float32 on the card, through both kernels
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, variants in (("phg112", ((False, {"aag": 6, "decoder_epilogue": 0}),
                                       (True, {"aag": 0, "decoder_epilogue": 6}))),
                           ("ph112", ((False, {"aag": 0, "decoder_epilogue": 0}),))):
        manifest, meta, golden = load_fixture(name)
        sd = fill_state_dict(manifest)
        x = torch.from_numpy(input_array(meta["seed"], (1, 3, meta["hw"], meta["hw"])))
        x = x.permute(0, 2, 3, 1).contiguous().to(device)
        for fused, want in variants:
            if name == "ph112":
                model = ResnestUnetParallelHead(2)
            else:
                model = ResnestUnetParallelHeadAttentionGate(2, meta["gating_level"],
                                                             use_fused_decoder=fused)
            load_reference_state_dict(model, sd)
            model = model.to(device).to(memory_format=torch.channels_last).eval()
            label = f"golden {name} fp32" + (", fused" if fused else "")
            with torch.inference_mode():
                out = counted(label, lambda: model(x), want)
            agg = out if name == "ph112" else out[1]
            errs = {"agg": max_err(agg.permute(0, 1, 4, 2, 3), golden["agg"])}
            if name == "phg112":
                (atts, atts_c), _ = out
                check(len(atts) == meta["n_atts"] and len(atts_c) == meta["n_atts_c"],
                      f"{label}: {len(atts)} + {len(atts_c)} attentions")
                for prefix, pyr in (("att", atts), ("attc", atts_c)):
                    for i, a in enumerate(pyr):
                        errs[f"{prefix}{i}"] = max_err(a.permute(0, 3, 1, 2), golden[f"{prefix}{i}"])
            log(f"[family] {label}: max|err| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            check(max(errs.values()) < 1e-3, f"{label}: golden parity failed {errs}")
            del model, out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # 7.2 the main path: cli train parallel_head_gate on a dual ROSE tree
    n_train, n_test = 16, 8
    root = os.path.join(tmp, "data")
    phantoms_ds = ds.SyntheticOcta((hw, hw), n=n_train + n_test, seed=31)
    for split, idx in (("train", range(n_train)), ("test", range(n_train, n_train + n_test))):
        base = os.path.join(root, "ROSE-1", "SVC", split)
        dirs = ("img", "gt", "thick_gt", "thin_gt") if split == "train" else ("img", "gt")
        for d in dirs:
            os.makedirs(os.path.join(base, d))
        for i in idx:
            s = phantoms_ds[i]
            write_png_gray(os.path.join(base, "img", f"{i:03d}.png"), s.image)
            write_png_gray(os.path.join(base, "gt", f"{i:03d}.png"), s.mask * 255)
            if split == "train":
                write_png_gray(os.path.join(base, "thick_gt", f"{i:03d}.png"), s.mask * 255)
                write_png_gray(os.path.join(base, "thin_gt", f"{i:03d}.png"),
                               (s.scribble == 2).astype(np.uint8) * 255)
    dual = ds.rose(root, "ROSE-1/SVC", "train", dual=True)
    for j in range(n_train):
        got, want = dual[j], phantoms_ds[j]
        check(np.array_equal(got.scribble, want.mask * 2)
              and np.array_equal(got.scribble_c, np.where(want.scribble == 2, 2, 0)),
              f"rose(dual=True) sample {j}: head targets differ from the files written")
    log(f"[family] {n_train} + {n_test} phantoms ({hw}²) in a ROSE tree with thick_gt and "
        f"thin_gt; rose(dual=True) reads head 0 from thick_gt, head 1 from thin_gt")

    ckpt_dir = os.path.join(tmp, "ckpt")
    over = {"model.architecture": "parallel_head_gate", "data.dataset": "rose",
            "data.root": root, "data.augment": "true", "data.augment_intensity": "0.1",
            "data.batch_size": "8", "data.image_size": f"[{hw},{hw}]",
            "train.compute_dtype": "bfloat16", "train.checkpoint_dir": ckpt_dir,
            "train.checkpoint_every": "4", "train.eval_every": "0", "train.log_every": "1",
            "train.steps": "4"}
    argv = [f"{k}={v}" for k, v in over.items()]
    eval_batches = n_test // 8
    text, records = counted("cli train parallel_head_gate, 4 steps + final evaluate",
                            lambda: run_cli(["train"] + argv),
                            {"aag": 7 * (4 + eval_batches), "decoder_epilogue": 0})
    train_metrics = printed_metrics(text)
    steps_logged = [r for r in records if r.startswith("step ")]
    check(len(steps_logged) == 4 and all("loss_disc=" in r for r in steps_logged),
          f"expected 4 logged steps with a critic loss, got {steps_logged}")
    check(any("discriminator[c] depth clamped 4 -> 1" in r for r in records),
          "no depth clamp logged for the c critic")
    check(CheckpointManager(ckpt_dir).all_steps() == [4], "no complete checkpoint at step 4")
    log(f"[family] cli train model.architecture=parallel_head_gate data.dataset=rose "
        f"data.augment=true bf16 {hw}² B=8, critics main depth 4 and c depth 1, noise on, 4 "
        f"steps: {len(steps_logged)} logged with a critic loss; metrics {train_metrics}")

    cfg = Config().apply_overrides(over)
    tr = Trainer(cfg, device=device)
    initial = tr.init_state()
    restored = CheckpointManager(ckpt_dir).restore_latest(tr.init_state())
    saved = torch.load(os.path.join(ckpt_dir, "step_00000004", "state.pt"), map_location="cpu",
                       weights_only=True)
    want, got = dict(leaves(saved)), dict(leaves(state_to_dict(restored)))
    check(want.keys() == got.keys(), "restored state has other entries than the checkpoint")
    n_tensors = 0
    for k, v in want.items():
        if torch.is_tensor(v):
            n_tensors += 1
            check(v.dtype == got[k].dtype and torch.equal(v, got[k].cpu()),
                  f"restored {k} differs from the checkpoint")
        else:
            check(v == got[k], f"restored {k}: {got[k]} != {v}")
    before, after = state_to_dict(initial), state_to_dict(restored)
    kinds = {"segmentor parameters": ("segmentor", "fc_c.weight"),
             "BN running stats": ("segmentor", "encoder_1.0.bn1.running_mean"),
             "main critic parameters": ("critic", "main.out.0.weight"),
             "c critic parameters": ("critic", "c.out.0.weight"),
             "main critic u/v": ("critic", "main.spectral_dict.spectral_3.0.weight_u"),
             "c critic u/v": ("critic", "c.spectral_dict.spectral_0.0.weight_v")}
    moved = {k: not torch.equal(before[m][n].cpu(), after[m][n].cpu())
             for k, (m, n) in kinds.items()}
    for opt, n_params in (("seg_opt", len(list(restored.segmentor.parameters()))),
                          ("critic_opt", len(list(restored.critic.parameters())))):
        st = after[opt]["opt"]["state"]
        moved[opt] = (len(st) == n_params and all(float(v["step"]) == 4 for v in st.values())
                      and after[opt]["sched"]["last_epoch"] == 4)
    log(f"[family] restore into a fresh state: equal to the checkpoint in all {n_tensors} "
        f"tensors, counters, generator and step; moved from the initial state: {moved}")
    check(all(moved.values()), f"state did not move: {moved}")
    del initial, before, after, saved, want, got

    live = counted("Trainer.evaluate, restored state", lambda: tr.evaluate(restored),
                   {"aag": 7 * eval_batches, "decoder_epilogue": 0})
    text, _ = counted("cli eval --checkpoint parallel_head_gate",
                      lambda: run_cli(["eval", "--checkpoint", ckpt_dir] + argv),
                      {"aag": 7 * eval_batches, "decoder_epilogue": 0})
    cli_metrics = printed_metrics(text)
    log(f"[family] cli eval --checkpoint prints {cli_metrics}; cli train printed "
        f"{train_metrics}; restored evaluate " + ", ".join(f"{k} {v:.6f}" for k, v in live.items()))
    check(cli_metrics == train_metrics, "cli eval --checkpoint differs from the live metrics")
    for k, v in live.items():
        check(abs(cli_metrics[k] - v) <= 5e-5 + 1e-6, f"cli eval {k}: {cli_metrics[k]} vs {v}")
    seg_sd = {k: v.detach().clone() for k, v in restored.segmentor.state_dict().items()}
    del tr, restored
    torch.cuda.empty_cache()

    # 7.3 the dual-critic step on the card against the same step on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    step_over = {"model.architecture": "parallel_head_gate",
                 "data.image_size": f"[{FAMILY_STEP_HW},{FAMILY_STEP_HW}]",
                 "data.batch_size": str(FAMILY_STEP_B), "data.synthetic_n": str(FAMILY_STEP_B),
                 "model.instance_noise": "false", "model.label_noise": "false",
                 "train.eval_every": "0", "train.log_every": "0"}
    step_cfg = Config().apply_overrides(step_over)
    gpu, cpu = Trainer(step_cfg, device=device), Trainer(step_cfg, device="cpu")
    s_gpu, s_cpu = gpu.init_state(), cpu.init_state()
    host = next(ds.batch_iterator(build_dataset(step_cfg), FAMILY_STEP_B, seed=0))
    l_gpu = counted(f"one fp32 dual-critic step, {FAMILY_STEP_HW}², B={FAMILY_STEP_B}",
                    lambda: gpu.train_step(s_gpu, gpu.device_batch(host)),
                    {"aag": 7, "decoder_epilogue": 0})
    l_cpu = cpu.train_step(s_cpu, cpu.device_batch(host))
    loss_err = max(abs(float(l_gpu[k]) / float(l_cpu[k]) - 1) for k in l_cpu)

    def rel_l2(a_mod, b_mod):
        pairs = [(p.grad.double().cpu(), q.grad.double()) for p, q in
                 zip(a_mod.parameters(), b_mod.parameters())]
        return float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs))
                     / torch.sqrt(sum((b ** 2).sum() for _, b in pairs)))

    grad_err = {"segmentor": rel_l2(s_gpu.segmentor, s_cpu.segmentor)}
    for name in ("main", "c"):
        grad_err[name] = rel_l2(s_gpu.critic[name], s_cpu.critic[name])
    # the float32 witness: the CPU step from segmentor weights one float32
    # rounding away (`nudge_`). From the ResNet init of the backbone (C.8)
    # at B = 2 float32 is itself ~8e-2 from float64 in the segmentor
    # gradient on the CPU, above TRAIN_GRAD_L2's 0.05 (set under torch's
    # default init): card and CPU, two independent float32 runs, may then
    # sit sqrt(2) witnesses apart
    s_nudged = cpu.init_state()
    nudge_(torch, s_nudged.segmentor)
    cpu.train_step(s_nudged, cpu.device_batch(host))
    witness = rel_l2(s_nudged.segmentor, s_cpu.segmentor)
    seg_bound = max(TRAIN_GRAD_L2["segmentor"], 2**0.5 * witness)
    log(f"[family] fp32 dual-critic step {FAMILY_STEP_HW}², B={FAMILY_STEP_B}, TF32 off, noise "
        f"off: card (AAG kernel) " + ", ".join(f"{k} {float(v):.6f}" for k, v in l_gpu.items())
        + f"; CPU (plain AAG) max loss rel err {loss_err:.2e} (bound "
        f"{TRAIN_LOSS_RTOL}); gradient rel L2 err " + ", ".join(
            f"{k} {v:.2e}" for k, v in grad_err.items())
        + f" (bounds segmentor max({TRAIN_GRAD_L2['segmentor']}, sqrt(2) x the witness "
        f"{witness:.2e}) = {seg_bound:.2e}, each critic {TRAIN_GRAD_L2['critic']})")
    check(loss_err <= TRAIN_LOSS_RTOL, f"card vs CPU dual-critic losses differ by {loss_err}")
    for name, err in grad_err.items():
        bound_ = seg_bound if name == "segmentor" else TRAIN_GRAD_L2["critic"]
        check(err <= bound_, f"card vs CPU {name} gradients differ by {err}")
    del gpu, cpu, s_gpu, s_cpu, s_nudged
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # 7.4 the fused dual-decoder eval forward against the unfused one, bf16
    images = torch.from_numpy(phantoms(8, hw, seed=13)).to(device)
    x = (images.to(torch.bfloat16) / 255.0).contiguous()
    folded = fold_batch_stats(seg_sd)
    models = {}
    for fused in (True, False):
        m = ResnestUnetParallelHeadAttentionGate(2, 4, use_fused_decoder=fused)
        load_reference_state_dict(m, folded)
        folded_inference(m)
        models[fused] = m.to(device, torch.bfloat16).to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        (atts_f, atts_cf), agg_f = counted(f"fused dual-decoder eval forward, bf16 {hw}² B=8",
                                           lambda: models[True](x),
                                           {"decoder_epilogue": 7, "bn_act": BN_SITES_DUAL})
        (atts_u, atts_cu), agg_u = counted(f"unfused dual-decoder eval forward, bf16 {hw}² B=8",
                                           lambda: models[False](x),
                                           {"aag": 7, "bn_act": BN_SITES_DUAL})
    check(len(atts_f) == len(atts_u) == 5 and len(atts_cf) == len(atts_cu) == 2,
          "the gated dual decoders at level 4 emit 5 + 2 attentions")
    agree = [float((agg_f[h].argmax(-1) == agg_u[h].argmax(-1)).float().mean()) for h in (0, 1)]
    prob_err = float((torch.softmax(agg_f.float(), -1) - torch.softmax(agg_u.float(), -1))
                     .abs().max())
    log(f"[family] fused vs unfused dual decoders, bf16 {hw}² B=8: argmax agreement "
        f"head 0 {agree[0]:.6f}, head 1 {agree[1]:.6f} (floor {PATH_AGREEMENT_FLOOR}), max |prob "
        f"diff| {prob_err:.3g}")
    check(bool(torch.isfinite(agg_f.float()).all()), "non-finite fused dual-decoder output")
    check(min(agree) >= PATH_AGREEMENT_FLOOR, f"fused and unfused dual decoders disagree {agree}")
    del models, x, images, agg_f, agg_u, atts_f, atts_u, atts_cf, atts_cu, folded, seg_sd
    torch.cuda.empty_cache()

    # 7.5 the facade with encoder gating: one combined forward with a pyramid
    facade, _ = octa_scribble_net((2, 3, hw, hw), (2, 2, hw, hw), True, encoder_gating=True,
                                  device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    x = (torch.from_numpy(phantoms(2, hw, seed=14)).to(device).float() / 255.0).contiguous()
    mask = torch.nn.functional.one_hot((torch.rand(2, hw, hw, generator=gen, device=device)
                                        > 0.9).long(), 2).float()
    pyr = [mask[:, ::2**i, ::2**i].contiguous() for i in range(5)]
    with torch.no_grad():
        out = counted(f"octa_scribble_net encoder_gating forward with a pyramid, {hw}² B=2",
                      lambda: facade(x, pyr, generator=gen), {"aag": 5, "decoder_epilogue": 0})
    gates = out["encoder_gates"]
    check(len(gates) == 5 and all(g.shape[-1] == 16 for g in gates), "encoder gate shapes")
    gate_err = max(float((g.sum(-1) - 1).abs().max()) for g in gates)
    check(gate_err < 1e-5, f"encoder gates do not sum to 1 ({gate_err})")
    check(out["y_fake"].shape == out["y_real"].shape == (2, 1)
          and bool(torch.isfinite(out["y_fake"]).all() and torch.isfinite(out["y_real"]).all()),
          "facade critic logits")
    log(f"[family] facade: gates {[tuple(g.shape[1:]) for g in gates]} (|sum - 1| <= "
        f"{gate_err:.1e}), attentions {[tuple(a.shape[1:3]) for a in out['attentions']]}, y_fake "
        f"{out['y_fake'].flatten().tolist()}, y_real {out['y_real'].flatten().tolist()}")
    del facade, out, x, mask, pyr
    torch.cuda.empty_cache()
    return paths


# phase 8: the native loader and data parallelism. Data-parallel bounds, one
# rank or two against one device on the full batch, float32 with TF32 off:
# the losses of a step as tests/test_parallel.py:221 (loss_sup 1e-5) and
# the card's float32 step (1e-4 relative); the step's segmentor gradient,
# to which an SGD update is proportional, by relative L2 as the update of
# tests/test_parallel.py:239 (0.10); BN running stats rtol 3e-3 atol 1e-3.
# Adam's first update is lr * sign(g) wherever |g| >> eps, so after it two
# runs whose gradients differ by float32 noise differ by 2 lr wherever a
# gradient sits at that noise. The 3-step `cli train` runs are therefore held
# to wider bounds, set from the card's readings and from a witness: one
# device against itself from weights one float32 rounding away (`nudge_`).
# Six runs of this phase on an H100 80GB HBM3 at 700 W read the update
# 0.1089-0.1091 apart by relative L2, the losses of steps 2-3 at most 9.4e-3
# apart (loss_adv), and the witness 0.080 and 4.0e-3 (PERF.md, section 6).
DP_HW, DP_B = 304, 8
DP_LOSS_ATOL, DP_LOSS_RTOL, DP_GRAD_L2, DP_BN_RTOL, DP_BN_ATOL = 1e-5, 1e-4, 0.10, 3e-3, 1e-3
DP_UPDATE3_L2, DP_LATER_LOSS_RTOL = 0.25, 5e-2
# eval metrics of 2 ranks (shards of 4 and a padded tail of 3) against one
# device's batches of 8: cuDNN may pick other algorithms per batch size, so a
# probability at the 0.5 cut may land on the other side
DP_EVAL_ATOL = 1e-4
N_TRAIN_TIFF, N_TEST_TIFF = 16, 13  # test batches of 8 and 5: a ragged tail


def png_bytes(arr, ftype):
    """An 8-bit grey PNG of (h, w) uint8 whose rows all use filter `ftype`
    (0-4), or cycle through the five with ftype 5."""
    import struct
    import zlib

    import numpy as np

    a = arr.astype(np.int32)
    left = np.pad(a, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(a, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(a, ((1, 0), (1, 0)))[:-1, :-1]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    preds = [np.zeros_like(a), left, up, (left + up) // 2,
             np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))]
    rows = []
    for y in range(a.shape[0]):
        f = y % 5 if ftype == 5 else ftype
        rows.append(bytes([f]) + ((a[y] - preds[f][y]) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    h, w = arr.shape
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + chunk(b"IEND", b""))


def bmp_bytes(arr):
    """An 8-bit palette BMP (grey palette, bottom-up rows)."""
    import struct

    h, w = arr.shape
    stride = (w + 3) & ~3
    palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
    rows = b"".join(arr[y].tobytes() + bytes(stride - w) for y in range(h - 1, -1, -1))
    off = 14 + 40 + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(rows), 0, 0, 256, 0)
            + palette + rows)


def lzw_bytes(data):
    """TIFF LZW: MSB-first codes from 9 to 12 bits, Clear first, the width
    growing one code early, as libtiff writes them."""
    out, acc, nacc = bytearray(), 0, 0
    table, nxt, nbits = {}, 258, 9

    def put(code):
        nonlocal acc, nacc
        acc, nacc = (acc << nbits) | code, nacc + nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    w = None
    for b in data:
        if w is None:
            w = b
            continue
        k = (w, b)
        if k in table:
            w = table[k]
            continue
        put(w)
        if nxt == 4094:  # table full: clear it
            put(256)
            table, nxt, nbits = {}, 258, 9
        else:
            table[k] = nxt
            nxt += 1
            if nxt == 1 << nbits:
                nbits += 1
        w = b
    if w is not None:
        put(w)
        nxt += 1  # the reader adds an entry on this code too
        if nxt == 1 << nbits and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def tiff_bytes(arr, lzw=False):
    """A little-endian 8-bit grey TIFF of (h, w) uint8 in one strip,
    uncompressed or LZW."""
    import struct

    h, w = arr.shape
    strip = lzw_bytes(arr.tobytes()) if lzw else arr.tobytes()
    ifd_at = 8 + len(strip) + (len(strip) & 1)
    entries = [(256, 3, w), (257, 3, h), (258, 3, 8), (259, 3, 5 if lzw else 1), (262, 3, 1),
               (273, 4, 8), (277, 3, 1), (278, 3, h), (279, 4, len(strip))]
    out = b"II*\0" + struct.pack("<I", ifd_at) + strip + bytes(ifd_at - 8 - len(strip))
    out += struct.pack("<H", len(entries))
    for tag, typ, value in entries:
        out += struct.pack("<HHI", tag, typ, 1) + (struct.pack("<HH", value, 0) if typ == 3
                                                   else struct.pack("<I", value))
    return out + bytes(4)


def write_rose_tiffs(root, n_train, n_test):
    """A ROSE-1/SVC tree of uncompressed TIFFs (img, gt, thin_gt) of
    SyntheticOcta phantoms at DP_HW², read back through `rose()` and the
    native loader and checked pixel for pixel."""
    import numpy as np

    from octave_tpu_torch.data import datasets as ds

    phantoms_ds = ds.SyntheticOcta((DP_HW, DP_HW), n=n_train + n_test, seed=31)
    split_of = {"train": range(n_train), "test": range(n_train, n_train + n_test)}
    for split, idx in split_of.items():
        base = os.path.join(root, "ROSE-1", "SVC", split)
        for d in ("img", "gt", "thin_gt"):
            os.makedirs(os.path.join(base, d))
        for i in idx:
            s = phantoms_ds[i]
            for d, arr in (("img", s.image), ("gt", s.mask * 255),
                           ("thin_gt", (s.scribble == 2).astype(np.uint8) * 255)):
                with open(os.path.join(base, d, f"{i:03d}.tif"), "wb") as f:
                    f.write(tiff_bytes(np.ascontiguousarray(arr, dtype=np.uint8)))
    for split, idx in split_of.items():
        folder = ds.rose(root, "ROSE-1/SVC", split)
        for j, i in enumerate(idx):
            got, want = folder[j], phantoms_ds[i]
            check(np.array_equal(got.image, want.image) and np.array_equal(got.mask, want.mask),
                  f"rose TIFF {split} sample {j} differs from the phantom written")


def _dp_overrides(root, **extra):
    """The phase's training config: ROSE TIFF tree, 304², B = 8, float32,
    noise off, no augmentation."""
    return {"data.dataset": "rose", "data.root": root, "data.batch_size": str(DP_B),
            "model.instance_noise": "false", "model.label_noise": "false",
            "train.eval_every": "0", "train.log_every": "1", **extra}


def _two_rank_worker(device, overrides, out_dir):
    """One rank of phase 8.4: evaluate the fresh state, then one float32
    step on this rank's rows of the first global batch. Rank 0 saves the
    step's mean segmentor gradient and BN running stats to out_dir."""
    import torch

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.parallel import ddp
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.config import Config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config().apply_overrides(overrides)
    tr = Trainer(cfg, device=device)
    state = tr.init_state()
    host = next(ds.batch_iterator(build_dataset(cfg), cfg.data.batch_size, seed=0))
    launch_counts(reset=True)
    metrics = tr.evaluate(state)
    torch.cuda.synchronize()
    eval_launches = launch_counts(reset=True)["aag"]
    losses = tr.train_step(state, tr.device_batch(*tr.shard(host)))
    torch.cuda.synchronize()
    step_launches = launch_counts(reset=True)["aag"]
    if ddp.rank() == 0:
        seg = state.segmentor
        torch.save({"grad": {k: p.grad.cpu() for k, p in seg.named_parameters()},
                    "bn": {k: v.cpu() for k, v in seg.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}},
                   os.path.join(out_dir, "rank0.pt"))
    return {"rank": ddp.rank(), "losses": {k: float(v) for k, v in losses.items()},
            "metrics": metrics, "eval_launches": eval_launches, "step_launches": step_launches}


def phase_parallel(torch):
    """Phase 8. Returns {kernel: {path: launches}} of its runs."""
    tmp = tempfile.mkdtemp(prefix="octave_parallel_")
    try:
        return _parallel(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _parallel(torch, tmp):
    import ctypes
    import json as _json
    import math

    import numpy as np

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.data import native
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.parallel import ddp
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.config import Config
    from octave_tpu_torch.utils.imageio import read_image

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}

    # 8.1 the loader, built from this checkout's source
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    lib_path = native.build()  # raises with the compiler's output
    ctypes.CDLL(str(lib_path))
    check(native.available(), f"native loader unavailable: {native.build_error()}")
    log(f"[parallel] native loader built from {native.SOURCE.relative_to(HERE)} into "
        f"{lib_path.relative_to(HERE)}")

    # 8.2 decoding: the committed TIFF fixtures; PNG filters, BMP, PGM
    fixtures = os.path.join(HERE, "tests", "torch_fixtures")
    with np.load(os.path.join(fixtures, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    for name, want in expected.items():
        got = native.decode_image(os.path.join(fixtures, f"{name}.tif"))
        check(np.array_equal(got, want), f"TIFF fixture {name} decodes to other pixels")
    batch = native.load_batch([os.path.join(fixtures, f"{n}.tif") for n in expected], (64, 64))
    check(all(np.array_equal(batch[i], w) for i, w in enumerate(expected.values())),
          "TIFF fixtures through load_batch")
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:DP_HW, 0:DP_HW]
    natural = np.clip(np.sin(xx / 9.0) * 50 + np.cos(yy / 13.0) * 50 + 128
                      + rng.normal(0, 12, (DP_HW, DP_HW)), 0, 255).astype(np.uint8)
    files = {}
    for ftype in range(6):
        files[f"png filter {ftype if ftype < 5 else 'cycling'}"] = ("png", png_bytes(natural,
                                                                                   ftype))
    files["bmp"] = ("bmp", bmp_bytes(natural))
    files["pgm"] = ("pgm", f"P5 {DP_HW} {DP_HW} 255\n".encode() + natural.tobytes())
    files["tiff"] = ("tif", tiff_bytes(natural))
    files["tiff lzw"] = ("tif", tiff_bytes(natural, lzw=True))
    for label, (ext, data) in files.items():
        p = os.path.join(tmp, label.replace(" ", "_") + "." + ext)
        with open(p, "wb") as f:
            f.write(data)
        got = native.decode_image(p)
        check(np.array_equal(got, natural), f"native {label}: other pixels")
        if ext != "tif":
            check(np.array_equal(read_image(p), got), f"{label}: native and numpy disagree")
    log(f"[parallel] decoding: {len(expected)} committed TIFF fixtures equal their expected "
        f"arrays (single files and load_batch); a {DP_HW}² image as PNG with each row filter, "
        f"BMP, PGM: native == numpy reader, byte for byte; as TIFF, uncompressed and LZW: "
        f"native exact")

    # 8.3 the slice's path: cli train on a ROSE tree of TIFFs, data-parallel
    root = os.path.join(tmp, "data")
    write_rose_tiffs(root, N_TRAIN_TIFF, N_TEST_TIFF)
    log(f"[parallel] {N_TRAIN_TIFF} + {N_TEST_TIFF} phantoms ({DP_HW}²) written as TIFFs into "
        f"a ROSE tree and read back through rose() and the native loader: pixels equal")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eval_batches = -(-N_TEST_TIFF // DP_B)
    runs = {}
    for label, dp in (("data_parallel, 1 rank", True), ("one device", False)):
        ckpt, logs = os.path.join(tmp, f"ckpt_{dp}"), os.path.join(tmp, f"log_{dp}")
        over = _dp_overrides(root, **{"train.steps": "3", "train.checkpoint_dir": ckpt,
                                      "train.log_dir": logs})
        if dp:
            over.update({"train.data_parallel": "true", "train.n_devices": "1"})
        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(free_port())} if dp else {}
        os.environ.update(env)
        try:
            launch_counts(reset=True)
            text, _ = run_cli(["train"] + [f"{k}={v}" for k, v in over.items()])
            torch.cuda.synchronize()
            got = launch_counts()
        finally:
            for k in env:
                del os.environ[k]
        want = launches_of({"aag": 5 * (3 + eval_batches)})
        log(f"[parallel] cli train data.dataset=rose (TIFF) {label}, {DP_HW}², B={DP_B}, fp32 "
            f"TF32 off, noise off, 3 steps + evaluate: launches {got} (expected {want}); "
            f"metrics {printed_metrics(text)}")
        check(got == want, f"cli train {label}: launch counts {got}, expected {want}")
        check(not torch.distributed.is_initialized(), "the cli left its process group")
        if dp:
            paths["aag"][f"cli train data_parallel (1 rank, NCCL), 3 steps + evaluate"] = got["aag"]
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            records = [_json.loads(line) for line in f]
        final = torch.load(os.path.join(ckpt, "step_00000003", "state.pt"), map_location="cpu",
                           weights_only=True)["segmentor"]
        runs[dp] = (records, final, printed_metrics(text))
    # the witness: one device again, the same 3 steps (Trainer.fit, what
    # `cli train` calls), from weights one float32 rounding away
    w_logs = os.path.join(tmp, "log_witness")
    tr_w = Trainer(Config().apply_overrides(_dp_overrides(
        root, **{"train.steps": "3", "train.log_dir": w_logs})), device="cuda")
    s_w = tr_w.init_state()
    nudge_(torch, s_w.segmentor)
    seg0_w = {k: v.cpu().clone() for k, v in s_w.segmentor.state_dict().items()}
    tr_w.fit(s_w)
    seg_w = {k: v.cpu() for k, v in s_w.segmentor.state_dict().items()}
    with open(os.path.join(w_logs, "metrics.jsonl")) as f:
        rec_w = [_json.loads(line) for line in f]
    del tr_w, s_w
    torch.cuda.empty_cache()

    (rec_dp, seg_dp, met_dp), (rec_1, seg_1, met_1) = runs[True], runs[False]
    check([r["step"] for r in rec_dp] == [r["step"] for r in rec_1] == [r["step"] for r in rec_w]
          == [1, 2, 3], "logged steps")
    loss_keys = [k for k in rec_1[0] if k.startswith("train/loss")]
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in loss_keys} for a, b in zip(rec_dp, rec_1)]
    rel_w = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in loss_keys} for a, b in zip(rec_w, rec_1)]
    seg0 = Trainer(Config().apply_overrides(_dp_overrides(root)), device="cpu") \
        .init_state().segmentor.state_dict()
    update3 = update_rel_l2(torch, seg_dp, seg_1, seg0, seg0)
    update3_w = update_rel_l2(torch, seg_w, seg_1, seg0_w, seg0)
    later, later_w = (max(v for r in rr[1:] for v in r.values()) for rr in (rel, rel_w))

    def per_step(rr):
        return "; ".join(f"step {i + 1} " + ", ".join(f"{k[11:]} {v:.1e}" for k, v in r.items())
                         for i, r in enumerate(rr))

    log(f"[parallel] cli data_parallel vs one device, per step loss rel diff: {per_step(rel)}; "
        f"segmentor update after 3 Adam steps, rel L2 {update3:.4e} (bound {DP_UPDATE3_L2}); "
        f"eval metrics max |diff| {max(abs(met_dp[k] - met_1[k]) for k in met_1):.2e}")
    log(f"[parallel] witness, one device from weights one float32 rounding away vs one device: "
        f"{per_step(rel_w)}; update rel L2 {update3_w:.4e}. Data parallel / witness: steps 2-3 "
        f"losses max {later:.1e} / {later_w:.1e} (bound {DP_LATER_LOSS_RTOL}), update "
        f"{update3:.4e} / {update3_w:.4e}")
    check(max(rel[0].values()) <= DP_LOSS_RTOL, f"first-step losses differ: {rel[0]}")
    check(abs(rec_dp[0]["train/loss_sup"] - rec_1[0]["train/loss_sup"]) < DP_LOSS_ATOL,
          "first-step loss_sup differs")
    check(later <= DP_LATER_LOSS_RTOL, f"steps 2-3 losses differ by {later}")
    check(update3 <= DP_UPDATE3_L2, f"the 3-step update differs by {update3}")

    # the step of one rank against one device on the same batch: gradient
    quiet = _dp_overrides(root)
    dp_cfg = Config().apply_overrides({**quiet, "train.data_parallel": "true"})
    one_cfg = Config().apply_overrides(quiet)
    host = next(ds.batch_iterator(build_dataset(one_cfg), DP_B, seed=0))
    ddp.init_distributed("nccl", f"tcp://127.0.0.1:{free_port()}", 0, 1)
    try:
        tr_dp, tr_1 = Trainer(dp_cfg, device="cuda"), Trainer(one_cfg, device="cuda")
        s_dp, s_1, s_w = tr_dp.init_state(), tr_1.init_state(), tr_1.init_state()
        nudge_(torch, s_w.segmentor)
        l_dp = tr_dp.train_step(s_dp, tr_dp.device_batch(*tr_dp.shard(host)))
        l_1 = tr_1.train_step(s_1, tr_1.device_batch(host))
        tr_1.train_step(s_w, tr_1.device_batch(host))
        grad_l2, grad_w = (rel_l2_pairs(torch, [(p.grad, q.grad) for p, q in
                                                zip(s.segmentor.parameters(),
                                                    s_1.segmentor.parameters())])
                           for s in (s_dp, s_w))
        loss_rel = max(abs(float(l_dp[k]) / float(l_1[k]) - 1) for k in l_1)
        log(f"[parallel] one fp32 step, 1 rank (synchronised BN, all-reduces) vs one device, "
            f"same batch: losses max rel diff {loss_rel:.2e} (bound {DP_LOSS_RTOL}); segmentor "
            f"gradient rel L2 {grad_l2:.2e} (bound {DP_GRAD_L2}); witness (one device from "
            f"weights one float32 rounding away): gradient rel L2 {grad_w:.2e}")
        check(loss_rel <= DP_LOSS_RTOL, f"1-rank step losses differ by {loss_rel}")
        check(grad_l2 <= DP_GRAD_L2, f"1-rank step gradient differs by {grad_l2}")
        del tr_dp, tr_1, s_dp, s_1, s_w, l_dp, l_1
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True

        # the same step in bf16: the synchronised BN's backward under autocast
        b16 = {**quiet, "train.compute_dtype": "bfloat16"}
        tr_dp = Trainer(Config().apply_overrides({**b16, "train.data_parallel": "true"}), "cuda")
        tr_1 = Trainer(Config().apply_overrides(b16), "cuda")
        l_dp = tr_dp.train_step(tr_dp.init_state(), tr_dp.device_batch(*tr_dp.shard(host)))
        l_1 = tr_1.train_step(tr_1.init_state(), tr_1.device_batch(host))
        loss_rel = {k: abs(float(l_dp[k]) / float(l_1[k]) - 1) for k in l_1}
        finite = all(math.isfinite(float(v)) for v in (*l_dp.values(), *l_1.values()))
        log(f"[parallel] one bf16 step, 1 rank vs one device, same batch and state: losses "
            f"finite {finite}, relative differences "
            + ", ".join(f"{k} {v:.2e}" for k, v in loss_rel.items())
            + f" (bound {BF16_LOSS_RTOL})")
        check(finite, "bf16 1-rank or one-device step losses not finite")
        check(max(loss_rel.values()) <= BF16_LOSS_RTOL, f"bf16 1-rank step losses: {loss_rel}")
        del tr_dp, tr_1, l_dp, l_1
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # 8.4 two ranks on the one card over gloo, CUDA tensors
    torch.backends.cudnn.allow_tf32 = False
    over = _dp_overrides(root, **{"train.data_parallel": "true"})
    ranks = ddp.launch(_two_rank_worker, 2, "gloo", ["cuda:0", "cuda:0"],
                       args=(over, tmp), timeout=600)
    one = Trainer(Config().apply_overrides(_dp_overrides(root)), device="cuda")
    state = one.init_state()
    met_1 = one.evaluate(state)
    host = next(ds.batch_iterator(build_dataset(one.cfg), DP_B, seed=0))
    l_1 = one.train_step(state, one.device_batch(host))
    r0 = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
    grad_l2 = rel_l2_pairs(torch, [(r0["grad"][k], p.grad.cpu()) for k, p in
                                   state.segmentor.named_parameters()])
    bn = state.segmentor.state_dict()
    bn_ok = all(bool(((r0["bn"][k] - bn[k].cpu()).abs()
                      <= DP_BN_ATOL + DP_BN_RTOL * bn[k].cpu().abs()).all()) for k in r0["bn"])
    losses = ranks[0]["losses"]
    loss_rel = max(abs(losses[k] / float(l_1[k]) - 1) for k in l_1)
    eval_diff = max(abs(ranks[r]["metrics"][k] - met_1[k]) for r in range(2) for k in met_1)
    counts = [(r["step_launches"], r["eval_launches"]) for r in ranks]
    log(f"[parallel] 2 ranks on one card over gloo (CUDA tensors), fp32 TF32 off, global "
        f"B={DP_B} (4 per rank), {DP_HW}²: losses "
        + ", ".join(f"{k} {v:.6f}" for k, v in losses.items())
        + f"; vs the full batch on one device: losses max rel diff {loss_rel:.2e} (bound "
        f"{DP_LOSS_RTOL}), loss_sup abs diff {abs(losses['loss_sup'] - float(l_1['loss_sup'])):.2e}"
        f" (bound {DP_LOSS_ATOL}), segmentor gradient rel L2 {grad_l2:.2e} (bound {DP_GRAD_L2}),"
        f" BN stats within rtol {DP_BN_RTOL} atol {DP_BN_ATOL}: {bn_ok}; evaluate of "
        f"{N_TEST_TIFF} (8 + a tail of 5 padded to 6) vs one device: max |metric diff| "
        f"{eval_diff:.2e} (bound {DP_EVAL_ATOL}); AAG launches per rank (step, eval) {counts}")
    check(ranks[0]["losses"] == ranks[1]["losses"], "the ranks report other losses")
    check(loss_rel <= DP_LOSS_RTOL and abs(losses["loss_sup"] - float(l_1["loss_sup"]))
          < DP_LOSS_ATOL, f"2-rank losses differ: {loss_rel}")
    check(grad_l2 <= DP_GRAD_L2, f"2-rank gradient differs by {grad_l2}")
    check(bn_ok, "2-rank BN running stats differ")
    check(eval_diff <= DP_EVAL_ATOL, f"2-rank evaluate differs by {eval_diff}")
    check(all(c == (5, 5 * eval_batches) for c in counts), f"2-rank launches {counts}")
    paths["aag"]["2 ranks on one card (gloo), per rank: one step"] = counts[0][0]
    paths["aag"]["2 ranks on one card (gloo), per rank: evaluate"] = counts[0][1]
    torch.backends.cudnn.allow_tf32 = True
    del one, state
    torch.cuda.empty_cache()
    return paths


# phase 9: int8 post-training quantisation. The floor is the JAX package's
# own gate on int8 against bf16 masks (bench.py:136-145), for the decoder
# scope it serves. Scope all moves the masks further in both packages (on
# the CPU at 304²: port 0.98880, JAX 0.98863 of pixels;
# tests/test_torch_quant.py::test_int8_scopes_shift_as_jax_at_304), so it is
# held to 0.98.
INT8_AGREEMENT_FLOOR = 0.99
INT8_ALL_AGREEMENT_FLOOR = 0.98


def int8_sites(pred):
    """The int8 convs of a Predictor's model: one kernel launch each per
    forward (a decoder's pair in one launch)."""
    from octave_tpu_torch.ops.quant import Int8Conv

    return sum(isinstance(m, Int8Conv) for m in pred.model.modules())


def phase_int8(torch, smi, serve, weights, images, predict_args, deploy_tmp):
    """Phase 9: the int8 Predictor on the committed trained weights at 304²,
    bf16, calibrated on a phantom batch: masks against the bf16 Predictor's
    on other phantoms (decoder scope through the fused epilogue, scope all,
    the unfused AAG configuration, B = 1, 8 and 32), launch counts (the int8
    conv kernel's too; no library int8 GEMM) and `cli predict --int8` on
    phase 6's PNG folder against a direct int8 Predictor. Returns {kernel:
    {path: launches}}."""
    import numpy as np

    from octave_tpu_torch.data.datasets import load_image_batch
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.train.trainer import Trainer
    from octave_tpu_torch.utils.checkpoint import CheckpointManager
    from octave_tpu_torch.utils.config import Config
    from octave_tpu_torch.utils.imageio import read_image

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}, "int8_conv": {}}
    calib = phantoms(SERVE_B, 304, seed=31)  # other phantoms than the requests'
    bf16_probs = serve(images)

    def counted(label, fn, want):
        """fn() with the kernel counts zeroed just before it and read just
        after; no library int8 GEMM (the plain route's) may run."""
        launch_counts(reset=True)
        quant.int8_mm.launches = 0
        result = fn()
        torch.cuda.synchronize()
        got, want, n_gemm = launch_counts(), launches_of(want), quant.int8_mm.launches
        log(f"[int8] {label}: launches {got} (expected {want}), library int8 GEMMs {n_gemm}")
        check(got == want and n_gemm == 0,
              f"{label}: launches {got} and {n_gemm} library int8 GEMMs, expected {want}, 0")
        for name, n in got.items():
            if n:
                paths[name][label] = n
        return result

    def agreement(label, probs, want, floor=INT8_AGREEMENT_FLOOR):
        check(probs.shape == want.shape and bool(np.isfinite(probs).all()),
              f"{label}: shape {probs.shape} or non-finite values")
        agree = float((probs.argmax(-1) == want.argmax(-1)).mean())
        log(f"[int8] {label}: argmax agreement with the bf16 Predictor {agree:.6f}, mean |dp| "
            f"{float(np.abs(probs - want).mean()):.3g} (floor {floor})")
        check(agree >= floor, f"{label}: int8 masks agree on {agree} of pixels")
        return agree

    # 9.1 calibrate and quantise: decoder scope, fused epilogue (the main path)
    int8 = Predictor(weights, int8_decoder=True, calibration_batches=[calib])
    int8_all = Predictor(weights, int8_decoder=True, calibration_batches=[calib],
                         int8_scope="all")
    int8_aag = Predictor(weights, int8_decoder=True, calibration_batches=[calib],
                         use_fused_decoder=False)
    n_sites = {k: len(p.int8_scales) for k, p in
               (("decoder", int8), ("all", int8_all), ("aag", int8_aag))}
    log(f"[int8] calibration on {SERVE_B} phantoms; scales: decoder {n_sites['decoder']}, all "
        f"{n_sites['all']}, unfused decoder {n_sites['aag']}")
    check(n_sites["decoder"] == n_sites["aag"] == 33 and n_sites["all"] > 100,
          f"scale counts {n_sites}")
    # one kernel launch per int8 conv: five convs a decoder, a pair's two
    # halves in one launch (33 scales, 25 launches)
    convs = {k: int8_sites(p) for k, p in (("decoder", int8), ("all", int8_all),
                                           ("aag", int8_aag))}
    check(convs["decoder"] == convs["aag"] == 25 and convs["all"] > 100,
          f"int8 convs {convs}")

    # 9.2 agreement with bf16 and the launch counts of each path
    probs = counted("int8 __call__ (decoder, fused)", lambda: int8(images),
                    {"decoder_epilogue": 5, "int8_conv": 25, "bn_act": BN_SITES})
    stack = np.stack([images, images[::-1]])
    many = counted("int8 predict_many k=2", lambda: int8.predict_many(stack),
                   {"decoder_epilogue": 10, "int8_conv": 50, "bn_act": 2 * BN_SITES})
    check(np.array_equal(many[0], probs), "int8 predict_many differs from __call__")
    agreements = {"decoder": agreement(f"scope decoder, fused, B={SERVE_B}", probs, bf16_probs)}
    probs_all = counted("int8 __call__ (scope all)", lambda: int8_all(images),
                        {"decoder_epilogue": 5, "int8_conv": convs["all"], "bn_act": BN_SITES})
    agreements["all"] = agreement(f"scope all, fused, B={SERVE_B}", probs_all, bf16_probs,
                                  INT8_ALL_AGREEMENT_FLOOR)
    probs_aag = counted("int8 __call__ (use_fused_decoder=False)", lambda: int8_aag(images),
                        {"aag": 5, "int8_conv": 25, "bn_act": BN_SITES})
    agreements["aag"] = agreement(f"scope decoder, AAG kernel, B={SERVE_B}", probs_aag,
                                  bf16_probs)
    for b in (1, 8):
        small = counted(f"int8 __call__ B={b}", lambda: int8(images[:b]),
                        {"decoder_epilogue": 5, "int8_conv": 25, "bn_act": BN_SITES})
        agreements[f"B={b}"] = agreement(f"scope decoder, fused, B={b}", small,
                                         bf16_probs[:b])

    # 9.3 cli predict --int8 on phase 6's PNG folder: calibrated on its first
    # batch of 8, against a direct int8 Predictor calibrated on the same batch
    out_dir = os.path.join(deploy_tmp, "pred_int8")
    test_dir = predict_args[predict_args.index("--images") + 1]
    files = sorted(os.path.join(test_dir, f) for f in os.listdir(test_dir))
    counted("cli predict --int8, 16 images in 2 batches",
            lambda: run_cli(["predict", "--out", out_dir, "--int8"] + predict_args),
            {"decoder_epilogue": 15, "int8_conv": 2 * 25, "bn_act": 3 * BN_SITES})
    x = np.repeat((load_image_batch(files, (304, 304)).astype(np.float32) / 255.0)[..., None],
                  3, axis=-1)
    overrides = dict(a.split("=", 1) for a in predict_args[4:])
    ckpt = predict_args[predict_args.index("--checkpoint") + 1]
    state = CheckpointManager(ckpt).restore_latest(
        Trainer(Config().apply_overrides(overrides)).init_state())
    direct = Predictor(state.segmentor.state_dict(), int8_decoder=True,
                       calibration_batches=[x[:8]])
    del state
    want = np.concatenate([direct(x[:8]), direct(x[8:])])[..., 1]
    cli_probs = np.stack([np.load(os.path.join(out_dir, os.path.basename(f)[:-4] + "_prob.npy"))
                          for f in files])
    cli_masks = np.stack([read_image(os.path.join(out_dir, os.path.basename(f)[:-4]
                                                  + "_mask.png")) for f in files])
    prob_err = float(np.abs(cli_probs - want).max())
    mask_agree = float((cli_masks == np.where(want >= 0.5, 255, 0)).mean())
    log(f"[int8] cli predict --int8 wrote {len(files)} .npy and masks; against the int8 "
        f"Predictor called directly: max |prob diff| {prob_err:.3g}, masks {mask_agree:.6f} "
        f"equal")
    check(prob_err <= SERVER_PROB_ATOL and mask_agree >= SERVER_MASK_FLOOR,
          "cli predict --int8 differs from the int8 Predictor called directly")
    del direct
    log(json.dumps({"int8": {"device": smi, "batch": SERVE_B, "agreement": agreements,
                             "scales": n_sites, "int8_convs": convs}}))
    return paths


# switches-phase bounds. A lowering against cuDNN's grouped conv in float32
# with TF32 off: the same sums in another order; a weight gradient sums up to
# B*H*W = 739,328 products (decoder_0 at B = 8), and on an H100 its order
# moved it 1.0e-4 of its largest value. In bf16 every output is rounded to
# bf16.
LOWERING_F32_REL = 1e-3
LOWERING_BF16_REL = 5e-2
# recomputing a region repeats its forward: the BN running statistics must
# match remat=False's within float32 rounding (a second update would move
# them by about the momentum, 0.1 of their size)
REMAT_BN_REL = 1e-5
# train.remat -> AAG launches in one step: the regions over the whole forward
# run the five gates again in their recompute; the block modes leave the
# gates out of every region
REMAT_MODES = {False: 5, True: 10, "conv": 10, "block": 5, "block-enc": 5, "block:012": 5,
               "block:01e34": 5, "block:012+conv": 5}


def phase_switches(torch, smi, weights, images, serve):
    """Phase 10: the memory and lowering switches. Returns {kernel: {path:
    launches}} of its runs."""
    tmp = tempfile.mkdtemp(prefix="octave_switches_")
    try:
        return _switches(torch, smi, weights, images, serve, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _switches(torch, smi, weights, images, serve, tmp):
    import numpy as np

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.models import resnest
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.train import schedule
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict
    from octave_tpu_torch.utils.config import Config

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}
    summary = {"device": smi}

    def counted(label, fn, want):
        """fn() with the launch counts zeroed just before it and read just after."""
        launch_counts(reset=True)
        result = fn()
        torch.cuda.synchronize()
        got, want = launch_counts(), launches_of(want)
        log(f"[switches] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        for name, n in got.items():
            if n:
                paths[name][label] = n
        return result

    # 10.1 every grouped conv shape of the 304² UNet's train forward at B = 8:
    # the lowerings against cuDNN's grouped conv, forward and both backwards
    shapes = {}
    model = ResnestUNet(2).cuda().to(memory_format=torch.channels_last).train()

    def record(name):
        def hook(mod, args):
            key = (tuple(args[0].shape), mod.out_channels, mod.kernel_size[0], mod.padding[0],
                   mod.groups, mod.bias is not None)
            shapes.setdefault(key, []).append(name)
        return hook

    hooks = [m.register_forward_pre_hook(record(n)) for n, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d) and m.groups > 1]
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        model(torch.rand(8, 304, 304, 3, device="cuda"))
    for h in hooks:
        h.remove()
    del model
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.backends.cudnn.allow_tf32 = False
    lower_rows, totals = [], {}
    try:
        for (xs, cout, k, pad, g, bias), names in shapes.items():
            cin = xs[1]
            base = torch.nn.Conv2d(cin, cout, k, 1, pad, groups=g, bias=bias).cuda()
            x32 = torch.randn(xs, generator=gen, device="cuda").contiguous(
                memory_format=torch.channels_last)
            ho = xs[2] + 2 * pad - k + 1
            gy32 = torch.randn((xs[0], cout, ho, ho), generator=gen, device="cuda").contiguous(
                memory_format=torch.channels_last)
            ref = None
            row = {"conv": names[0], "count": len(names), "x": list(xs), "cout": cout, "k": k,
                   "groups": g}
            for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                conv = torch.nn.Conv2d(cin, cout, k, 1, pad, groups=g, bias=bias).cuda()
                conv.load_state_dict(base.state_dict())
                conv = conv.to(dt).to(memory_format=torch.channels_last)
                impls = {"cudnn": conv, "dense": resnest.DenseGroupsConv2d.of(conv),
                         "einsum": resnest.EinsumGroupsConv2d.of(conv)}
                x = x32.to(dt).requires_grad_()
                gy = gy32.to(dt)

                for name, m in impls.items():
                    out = m(x)
                    gx, gw = torch.autograd.grad(out, (x, conv.weight), gy)
                    torch.cuda.synchronize()
                    got = [t.float() for t in (out, gx, gw)]
                    if ref is None:  # cuDNN float32, TF32 off: the reference
                        ref = got
                    err = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(got, ref))
                    ms = timer.ms(lambda: torch.autograd.grad(m(x), (x, conv.weight), gy),
                                  reps=3, warmup=1)
                    row[f"{name}_{dname}"] = {"ms": ms, "rel_err": err}
                    totals[(name, dname)] = totals.get((name, dname), 0.0) + ms * len(names)
                    if name != "cudnn":
                        bound = LOWERING_F32_REL if dt == torch.float32 else LOWERING_BF16_REL
                        check(err <= bound, f"{name} lowering of {names[0]} {dname}: max err "
                              f"{err:.3g} of max over {bound}")
                del impls, x, gy, out, gx, gw, got
            log(f"[switches] grouped conv {names[0]} (x{len(names)}) x {tuple(xs)} -> {cout}, "
                f"{k}x{k}, groups {g}: fwd+bwd ms (max err / max vs cuDNN float32) "
                + "; ".join(f"{d} " + ", ".join(
                    f"{n} {row[f'{n}_{d}']['ms']:.3f} ({row[f'{n}_{d}']['rel_err']:.1e})"
                    for n in ("cudnn", "dense", "einsum")) for d in ("float32", "bfloat16")))
            lower_rows.append(row)
            del ref, x32, gy32, base
    finally:
        torch.backends.cudnn.allow_tf32 = True
    log(f"[switches] all {sum(len(v) for v in shapes.values())} grouped convs of one 304² "
        f"B=8 forward, fwd+bwd ms summed over the model on {smi}: "
        + "; ".join(f"{d}: " + ", ".join(f"{n} {totals[(n, d)]:.2f}"
                                         for n in ("cudnn", "dense", "einsum"))
                    for d in ("float32", "bfloat16")))
    summary["lowerings"] = {"convs": lower_rows,
                            "model_ms": {f"{n}_{d}": v for (n, d), v in totals.items()}}
    torch.cuda.empty_cache()

    # 10.2 the lowered Predictors beside the default one (bf16, B = 32)
    base_probs = serve(images)
    lowered = {"dense_groups=decoder": Predictor(weights, dense_groups="decoder"),
               "einsum_groups=decoder+enc": Predictor(weights, einsum_groups="decoder+enc")}
    agree = {}
    for label, pred in lowered.items():
        probs = counted(f"Predictor({label}) __call__", lambda: pred(images),
                        {"aag": 0, "decoder_epilogue": 5, "bn_act": BN_SITES})
        check(probs.shape == base_probs.shape and bool(np.isfinite(probs).all()),
              f"{label}: shape or non-finite values")
        agree[label] = float((probs.argmax(-1) == base_probs.argmax(-1)).mean())
        check(agree[label] >= PATH_AGREEMENT_FLOOR, f"{label}: argmax agreement "
              f"{agree[label]} with the default Predictor")
    log(f"[switches] lowered Predictors, 304² bf16 trained weights, B={SERVE_B}: "
        f"argmax agreement with the default {agree}")
    summary["serving"] = {"agreement": agree}
    del lowered
    torch.cuda.empty_cache()

    # 10.3 remat: one unet step at 304², B = 8, per mode from the same state
    # and batch, in bf16 and float32
    def trainer(mode, dtype="bfloat16", **extra):
        over = {"data.synthetic_n": "8", "data.batch_size": "8",
                "train.remat": str(mode).lower(), "model.instance_noise": "false",
                "model.label_noise": "false", "train.eval_every": "0", "train.log_every": "0",
                **extra}
        if dtype == "bfloat16":
            over["train.compute_dtype"] = "bfloat16"
        return Trainer(Config().apply_overrides(over), device="cuda")

    def batch_of(tr):
        host = next(ds.batch_iterator(build_dataset(tr.cfg), tr.cfg.data.batch_size, seed=0))
        return tr.device_batch(host)

    def bn_stats(seg):
        return {n: b.detach().clone() for n, b in seg.named_buffers()
                if n.endswith(("running_mean", "running_var", "num_batches_tracked"))}

    def grads(seg):
        return [p.grad.detach().clone() for p in seg.parameters()]

    remat_rows = {}
    b8 = batch_of(trainer(False))
    first = {}
    for mode, want_aag in REMAT_MODES.items():
        tr = trainer(mode)
        state = tr.init_state()
        losses = counted(f"bf16 step, remat={mode!r}", lambda: tr.train_step(state, b8),
                         {"aag": want_aag, "decoder_epilogue": 0})
        stats = bn_stats(state.segmentor)
        nbt = [int(v) for n, v in stats.items() if n.endswith("num_batches_tracked")]
        check(nbt and set(nbt) == {1}, f"remat={mode!r}: num_batches_tracked {set(nbt)}")
        row = {"losses": {k: float(v) for k, v in losses.items()}}
        if mode is False:
            first = {"losses": row["losses"], "stats": stats}
        else:
            loss_err = max(abs(row["losses"][k] - v) / max(abs(v), 1e-12)
                           for k, v in first["losses"].items())
            bn_err = max(float((stats[n].double() - v.double()).abs().max()
                               / max(float(v.double().abs().max()), 1e-30))
                         for n, v in first["stats"].items() if not n.endswith("tracked"))
            row.update(loss_rel=loss_err, bn_rel=bn_err)
            check(bn_err <= REMAT_BN_REL, f"remat={mode!r}: BN running statistics "
                  f"{bn_err:.3g} from remat=False's (bound {REMAT_BN_REL})")
            check(loss_err <= 1e-6, f"remat={mode!r}: step-1 losses {loss_err:.3g} from "
                  "remat=False's (the forward is the same)")
            log(f"[switches] remat={mode!r}, bf16: step-1 losses {loss_err:.2e}, BN stats "
                f"{bn_err:.2e} from remat=False")
        remat_rows[str(mode)] = row
        del tr, state, losses
        torch.cuda.empty_cache()

    # float32 (TF32 off): step-2 losses and the step-1 gradient against
    # remat=False, beside a witness: remat=False from weights one float32
    # rounding away (`nudge_`)
    torch.backends.cudnn.allow_tf32 = False
    f32 = {}
    try:
        b8f = batch_of(trainer(False, dtype="float32"))
        for mode in [False, *REMAT_MODES, "witness"]:
            if mode in f32:
                continue
            tr = trainer(False if mode == "witness" else mode, dtype="float32")
            state = tr.init_state()
            if mode == "witness":
                nudge_(torch, state.segmentor)
            tr.train_step(state, b8f)
            g1 = grads(state.segmentor)
            l2 = {k: float(v) for k, v in tr.train_step(state, b8f).items()}
            f32[mode] = (g1, l2)
            del tr, state
        g0, l0 = f32[False]
        wg = rel_l2_pairs(torch, list(zip(f32["witness"][0], g0)))
        wl = max(abs(f32["witness"][1][k] - v) / max(abs(v), 1e-12) for k, v in l0.items())
        for mode in REMAT_MODES:
            if mode is False:
                continue
            ge = rel_l2_pairs(torch, list(zip(f32[mode][0], g0)))
            le = max(abs(f32[mode][1][k] - v) / max(abs(v), 1e-12) for k, v in l0.items())
            remat_rows[str(mode)].update(f32_grad_rel_l2=ge, f32_step2_loss_rel=le)
            check(ge <= max(wg, 1e-6) and le <= max(wl, 1e-6),
                  f"remat={mode!r} float32: gradient {ge:.3g}, step-2 losses {le:.3g} from "
                  f"remat=False, over the witness's {wg:.3g}, {wl:.3g}")
        log("[switches] float32 (TF32 off) against remat=False: step-1 gradient rel L2 / "
            "step-2 losses max rel: "
            + ", ".join(f"{m} {remat_rows[str(m)]['f32_grad_rel_l2']:.2e} / "
                        f"{remat_rows[str(m)]['f32_step2_loss_rel']:.2e}"
                        for m in REMAT_MODES if m is not False)
            + f"; witness (weights one float32 rounding away) {wg:.2e} / {wl:.2e}")
        summary["remat_witness"] = {"grad_rel_l2": wg, "step2_loss_rel": wl}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    del f32
    summary["remat"] = remat_rows
    torch.cuda.empty_cache()

    # 10.4 the bf16 moment: the first moment's bytes against fused Adam's
    tr = trainer(False)
    state = tr.init_state()
    tr.train_step(state, b8)
    moment_bytes = {}
    for label, make in (("fused Adam", lambda ps: torch.optim.Adam(ps, lr=1e-4, fused=True)),
                        ("bf16 moment", lambda ps: schedule.MomentAdam(ps, 1e-4))):
        nbytes = 0
        for module in (state.segmentor, state.critic):
            opt = make([p for p in module.parameters()])
            opt.step()
            nbytes += sum(s["exp_avg"].nbytes for s in opt.state.values())
            del opt
        moment_bytes[label] = nbytes
    saved = moment_bytes["fused Adam"] - moment_bytes["bf16 moment"]
    n_params = sum(p.numel() for m in (state.segmentor, state.critic) for p in m.parameters()
                   if p.grad is not None)
    check(saved == 2 * n_params, f"bf16 moment saves {saved} bytes for {n_params} parameters")
    log(f"[switches] optimizer step of both players: first moment "
        f"{moment_bytes['fused Adam'] / 1e6:.1f} MB (fused Adam) -> "
        f"{moment_bytes['bf16 moment'] / 1e6:.1f} MB (bf16 moment; {saved / 1e6:.1f} MB saved, "
        f"{n_params / 1e6:.2f}M parameters)")
    summary["moment_exp_avg_bytes"] = moment_bytes
    del tr, state
    torch.cuda.empty_cache()

    # cli train with every switch: steps_per_call 2, block remat of depths
    # 0-2, dense decoder depths 0-1, the bf16 moment; 4 steps, checkpoint
    # cadence 3 (crossed at step 4 by the second call)
    ckpt_dir = os.path.join(tmp, "ckpt")
    over = {"data.synthetic_n": "8", "data.batch_size": "8", "train.compute_dtype": "bfloat16",
            "train.steps_per_call": "2", "train.remat": "block:012",
            "train.dense_groups": "decoder:01", "optim.moment_dtype": "bfloat16",
            "train.checkpoint_dir": ckpt_dir, "train.checkpoint_every": "3",
            "train.eval_every": "0", "train.log_every": "1", "train.steps": "4"}
    saves = []
    save = CheckpointManager.save

    def recorded(self, step, st):
        written = save(self, step, st)
        saves.append((int(step), written))
        return written

    CheckpointManager.save = recorded
    try:
        text, records = counted("cli train with the switches, 4 steps + final evaluate",
                                lambda: run_cli(["train"] + [f"{k}={v}" for k, v in over.items()]),
                                {"aag": 5 * 4 + 5, "decoder_epilogue": 0})
    finally:
        CheckpointManager.save = save
    logged = [r.split()[1] for r in records if r.startswith("step ")]
    check(logged == ["2", "4"], f"cli train logged steps {logged}, expected 2 and 4")
    check(saves == [(4, True), (4, False)] and CheckpointManager(ckpt_dir).all_steps() == [4],
          f"checkpoint saves {saves}: expected the cadence's at step 4, then the final one")
    train_metrics = printed_metrics(text)
    tr = Trainer(Config().apply_overrides(over), device="cuda")
    restored = CheckpointManager(ckpt_dir).restore_latest(tr.init_state())
    on_disk = torch.load(os.path.join(ckpt_dir, "step_00000004", "state.pt"),
                         map_location="cpu", weights_only=False)
    want, got = dict(leaves(on_disk)), dict(leaves(state_to_dict(restored)))
    check(want.keys() == got.keys(), "restored state has other entries than the checkpoint")
    n_tensors = 0
    for key, v in want.items():
        if torch.is_tensor(v):
            n_tensors += 1
            check(v.dtype == got[key].dtype and torch.equal(v, got[key].cpu()),
                  f"restored {key} differs from the checkpoint ({got[key].dtype}, {v.dtype})")
        else:
            check(v == got[key], f"restored {key}: {got[key]} != {v}")
    for opt in (restored.seg_opt, restored.critic_opt):
        check(isinstance(opt.opt, schedule.MomentAdam) and all(
            s["exp_avg"].dtype == torch.bfloat16 for s in opt.opt.state.values()),
              "restored optimizer lost the bf16 moment")
    del tr, restored, on_disk, want, got
    text, _ = counted("cli eval --checkpoint", lambda: run_cli(
        ["eval", "--checkpoint", ckpt_dir] + [f"{k}={v}" for k, v in over.items()]),
        {"aag": 5, "decoder_epilogue": 0})
    eval_metrics = printed_metrics(text)
    # both commands print 4 decimals
    check(eval_metrics.keys() == train_metrics.keys() and all(
        abs(eval_metrics[k] - v) <= 1e-4 + 1e-9 for k, v in train_metrics.items()),
          f"cli eval printed {eval_metrics}, cli train {train_metrics}")
    log(f"[switches] cli train steps_per_call=2 remat=block:012 dense_groups=decoder:01 "
        f"moment bf16, 304² B=8 bf16, 4 steps: logged steps "
        f"{logged}, saves {saves}; restore equal to the checkpoint in {n_tensors} tensors, "
        f"exp_avg bf16; cli eval --checkpoint prints train's metrics {train_metrics}")

    # Trainer.fit at steps_per_call 1, 2 and 4, 12 steps each, on one state
    base_over = {"data.synthetic_n": "8", "data.batch_size": "8",
                 "train.compute_dtype": "bfloat16", "train.eval_every": "0",
                 "train.log_every": "0"}
    state = Trainer(Config().apply_overrides(base_over), device="cuda").init_state()
    for k in (1, 2, 4):
        tr = Trainer(Config().apply_overrides({**base_over, "train.steps_per_call": str(k),
                                               "train.steps": str(state.step + 12)}),
                     device="cuda")
        state = tr.fit(state)
    check(state.step == 36, f"the three fits ended at step {state.step}")
    del state, tr, b8
    torch.cuda.empty_cache()
    log(json.dumps({"switches": summary}))
    return paths


# surface-phase bounds: float16 against float32 losses as phase 5 holds bf16
F16_LOSS_RTOL = BF16_LOSS_RTOL
SURFACE_FLOOD = 128


def phase_surface(torch, smi, weights, images, serve):
    """Phase 11: the rest of the JAX package's surface. Returns {kernel:
    {path: launches}} of its runs."""
    tmp = tempfile.mkdtemp(prefix="octave_surface_")
    try:
        return _surface(torch, smi, weights, images, serve, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _surface(torch, smi, weights, images, serve, tmp):
    import numpy as np

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.ops import common
    from octave_tpu_torch.ops.kernels import aag as aag_mod
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.parallel.mesh import make_mesh
    from octave_tpu_torch.serve import BatchServer, Predictor
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.config import Config
    from octave_tpu_torch.utils.imageio import write_png_gray

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}
    summary = {"device": smi, "device_count": torch.cuda.device_count()}

    def counted(label, fn, want):
        """fn() with the launch counts zeroed just before it and read just after."""
        launch_counts(reset=True)
        result = fn()
        torch.cuda.synchronize()
        got, want = launch_counts(), launches_of(want)
        log(f"[surface] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        for name, n in got.items():
            if n:
                paths[name][label] = n
        return result

    # 11.1 float16 training: one unet step from the default Config (304²,
    # B = 8, noise off) in float16 against float32 (TF32 off) from the same
    # seeded state and batch, through the AAG kernel in float16
    def trainer(dtype, **extra):
        over = {"data.synthetic_n": "8", "data.batch_size": "8", "model.instance_noise": "false",
                "model.label_noise": "false", "train.eval_every": "0", "train.log_every": "0",
                **extra}
        if dtype:
            over["train.compute_dtype"] = dtype
        return Trainer(Config().apply_overrides(over), device="cuda")

    def batch_of(tr):
        host = next(ds.batch_iterator(build_dataset(tr.cfg), tr.cfg.data.batch_size, seed=0))
        return tr.device_batch(host)

    seen = []
    launch = aag_mod._launch

    def recording(x, w, b, out_dtype, yhat_dtype):
        seen.append(out_dtype)  # the dtype the kernel rounds x to and gates in
        return launch(x, w, b, out_dtype, yhat_dtype)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32, f16 = trainer(None), trainer("float16")
        l32 = f32.train_step(f32.init_state(), batch_of(f32))
        state16 = f16.init_state()
        batch16 = batch_of(f16)
        aag_mod._launch = recording
        try:
            l16 = counted("float16 unet step (304², B=8)",
                          lambda: f16.train_step(state16, batch16),
                          {"aag": 5, "decoder_epilogue": 0})
        finally:
            aag_mod._launch = launch
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
    check(seen == [torch.float16] * 5, f"the AAG kernel gated in {seen}")
    f16_err = {k: abs(float(l16[k]) / float(l32[k]) - 1) for k in l32}
    check(all(torch.isfinite(v) for v in l16.values()), f"float16 step losses {l16}")
    check(max(f16_err.values()) <= F16_LOSS_RTOL, f"float16 vs float32 losses: {f16_err}")
    # float16's range (65,504) at 304²: the largest logits of the step's
    # forward, taken under the same autocast (the losses are float32 casts)
    with torch.no_grad(), torch.autocast("cuda", torch.float16):
        atts, agg, _ = state16.segmentor(batch16["image"])
        y_fake = state16.critic(list(atts[:5]), state16.generator, update=False)
        y_real = state16.critic([p.half() for p in batch16["mask_pyramid"][:5]],
                                state16.generator, update=False)
    ranges = {"agg map": float(agg.float().abs().max()),
              "attention pyramid": max(float(a.float().abs().max()) for a in atts),
              "critic logits": max(float(y.float().abs().max()) for y in (y_fake, y_real))}
    check(all(np.isfinite(v) and v < 65504 for v in ranges.values()),
          f"a float16 logit overflows: {ranges}")
    log(f"[surface] float16 vs float32 step (TF32 off), 304², B=8, noise off, on {smi}: "
        f"float16 {', '.join(f'{k} {float(v):.6f}' for k, v in l16.items())}; relative "
        f"differences {', '.join(f'{k} {v:.2e}' for k, v in f16_err.items())} (bound "
        f"{F16_LOSS_RTOL}); AAG gating in {sorted(set(str(d) for d in seen))}; largest |value| "
        f"in float16 {', '.join(f'{k} {v:.4g}' for k, v in ranges.items())}")
    summary["f16_step"] = {"losses": {k: float(v) for k, v in l16.items()},
                           "rel_to_f32": f16_err, "max_abs": ranges}
    del f32, l32
    history = [f16.train_step(state16, batch16) for _ in range(10)]
    sup = [float(h["loss_sup"]) for h in history]
    check(all(bool(torch.isfinite(v)) for h in history for v in h.values()),
          "non-finite losses in 10 float16 steps")
    check(sup[-1] < sup[0], f"loss_sup did not fall over 10 float16 steps: {sup}")
    log(f"[surface] 10 float16 steps on one batch (noise off): loss_sup {sup[0]:.5f} -> "
        f"{sup[-1]:.5f}, every loss finite")
    summary["f16_sup"] = sup
    del f16, state16, batch16, history
    torch.cuda.empty_cache()

    # cli train train.compute_dtype=float16 on a ROSE tree of PNGs: 2 steps
    # and the final evaluate
    root = os.path.join(tmp, "data")
    phantom_ds = ds.SyntheticOcta((304, 304), n=16, seed=41)
    for split, idx in (("train", range(8)), ("test", range(8, 16))):
        base = os.path.join(root, "ROSE-1", "SVC", split)
        for d in ("img", "gt"):
            os.makedirs(os.path.join(base, d))
        for i in idx:
            write_png_gray(os.path.join(base, "img", f"{i:03d}.png"), phantom_ds[i].image)
            write_png_gray(os.path.join(base, "gt", f"{i:03d}.png"), phantom_ds[i].mask * 255)
    over = {"data.dataset": "rose", "data.root": root, "data.batch_size": "8",
            "train.compute_dtype": "float16", "train.steps": "2", "train.eval_every": "0",
            "train.log_every": "1"}
    text, records = counted("cli train train.compute_dtype=float16, 2 steps + final evaluate",
                            lambda: run_cli(["train"] + [f"{k}={v}" for k, v in over.items()]),
                            {"aag": 5 * 2 + 5, "decoder_epilogue": 0})
    logged = [r for r in records if r.startswith("step ")]
    metrics = printed_metrics(text)
    check(len(logged) == 2 and "nan" not in " ".join(logged).lower()
          and all(0.0 <= v <= 1.0 for v in metrics.values()),
          f"cli train float16: logged {logged}, metrics {metrics}")
    log(f"[surface] cli train train.compute_dtype=float16 on a ROSE tree of 8 + 8 PNGs: "
        f"{len(logged)} steps logged, no nan; metrics {metrics}")

    # 11.2 the fan-out: Predictor(mesh=...) over every visible card and as
    # two replicas on cuda:0, bf16, uint8 in, B = 32, trained weights
    dev0 = torch.device("cuda", 0)
    single = serve(images)
    fans = {"make_mesh()": Predictor(weights, mesh=make_mesh()),
            "(cuda:0, cuda:0)": Predictor(weights, mesh=(dev0, dev0))}
    stack = np.broadcast_to(images[None], (4, *images.shape)).copy()
    fan_rows = {}
    for label, fan in fans.items():
        n = len(fan.replicas)
        probs = counted(f"Predictor(mesh={label}) __call__, {n} replicas", lambda: fan(images),
                        {"aag": 0, "decoder_epilogue": 5 * n, "bn_act": BN_SITES * n})
        many = counted(f"Predictor(mesh={label}) predict_many k=4",
                       lambda: fan.predict_many(stack),
                       {"aag": 0, "decoder_epilogue": 20 * n, "bn_act": 4 * BN_SITES * n})
        check(probs.shape == single.shape and bool(np.isfinite(probs).all()),
              f"fan-out {label}: shape or non-finite values")
        agree = float((probs.argmax(-1) == single.argmax(-1)).mean())
        agree_many = float((many.argmax(-1) == single[None].argmax(-1)).mean())
        check(min(agree, agree_many) >= PATH_AGREEMENT_FLOOR,
              f"fan-out {label}: argmax agreement {agree} / {agree_many} with the single one")
        fan_rows[label] = {"replicas": n, "agreement": agree, "agreement_many": agree_many,
                           "max_abs_prob": float(np.abs(probs - single).max())}
    log(f"[surface] fan-out against the single Predictor (304² bf16, B={SERVE_B}), "
        f"torch.cuda.device_count() = {torch.cuda.device_count()}: {fan_rows}")

    # a BatchServer flood through the two replicas on cuda:0, in order
    # against the fanned-out Predictor called directly
    fan = fans["(cuda:0, cuda:0)"]
    base_imgs = phantoms(64, 304, seed=13)
    flood = [np.roll(base_imgs[i % 64], i, axis=1) for i in range(SURFACE_FLOOD)]
    direct = np.concatenate([fan(np.stack(flood[i:i + SERVE_B]))
                             for i in range(0, SURFACE_FLOOD, SERVE_B)])
    def flood_through(pred):
        """(results, launch counts, k per dispatch) of the flood through a
        BatchServer over `pred`."""
        dispatched = []
        dispatch = pred.predict_many_device

        def recording_dispatch(stack):
            dispatched.append(stack.shape[0])
            return dispatch(stack)

        pred.predict_many_device = recording_dispatch  # the server's only way to the device
        try:
            with BatchServer(pred, batch=SERVE_B, image_hw=(304, 304), ks=(1, 2, 4)) as srv:
                del dispatched[:]  # the warm-up's
                launch_counts(reset=True)
                outs = list(srv.map(iter(flood)))
                torch.cuda.synchronize()
                return outs, launch_counts(), dispatched
        finally:
            del pred.predict_many_device

    outs, got_launches, dispatched = flood_through(fan)
    label = f"BatchServer flood of {SURFACE_FLOOD} over Predictor(mesh=(cuda:0, cuda:0))"
    want = launches_of({"decoder_epilogue": 5 * 2 * sum(dispatched),
                        "bn_act": BN_SITES * 2 * sum(dispatched)})
    log(f"[surface] {label}: launches {got_launches} (expected {want}: 5 and {BN_SITES} per "
        f"replica per batch, k = {dispatched})")
    check(got_launches == want, f"{label}: launch counts {got_launches}, expected {want}")
    for name in ("decoder_epilogue", "bn_act"):
        paths[name][label] = got_launches[name]
    got = np.stack(outs)
    err = float(np.abs(got - direct).max())
    agree = float(((got[..., 1] >= 0.5) == (direct[..., 1] >= 0.5)).mean())
    check(len(outs) == SURFACE_FLOOD and err <= SERVER_PROB_ATOL and agree >= SERVER_MASK_FLOOR,
          f"fanned-out flood: {len(outs)} results, max |prob diff| {err}, agreement {agree}")
    log(f"[surface] BatchServer flood of {SURFACE_FLOOD} over Predictor(mesh=(cuda:0, cuda:0)): "
        f"in order, max |prob diff| {err:.3g} and mask agreement {agree:.6f} against the "
        f"direct path")
    summary["fan_out"] = {"rows": fan_rows}
    del fans, fan
    torch.cuda.empty_cache()

    # 11.3 the ConvTranspose lowering: the Predictor under "einsum" against
    # "native", and the five Upsampling shapes of a 304², B = 8 forward
    shapes = []
    model = ResnestUNet(2).cuda().to(torch.bfloat16).to(memory_format=torch.channels_last).eval()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((tuple(args[0].shape), tuple(mod.up.weight.shape))))
        for n, m in model.named_modules() if n.startswith("upsampling_") and "." not in n]
    with torch.inference_mode():
        model.predict(torch.rand(8, 304, 304, 3, device="cuda", dtype=torch.bfloat16))
    for h in hooks:
        h.remove()
    del model
    check(len(shapes) == 5, f"{len(shapes)} Upsampling calls in one forward")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    up_rows = []
    try:
        common.set_conv_transpose_impl("einsum")
        probs = counted('Predictor __call__ under set_conv_transpose_impl("einsum")',
                        lambda: serve(images),
                        {"aag": 0, "decoder_epilogue": 5, "bn_act": BN_SITES})
        agree = float((probs.argmax(-1) == single.argmax(-1)).mean())
        check(bool(np.isfinite(probs).all()) and agree >= PATH_AGREEMENT_FLOOR,
              f"einsum ConvTranspose Predictor: argmax agreement {agree} with native")
        for xs, ws in shapes:
            x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            wt = (torch.randn(ws, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
            bias = (torch.randn(ws[1], generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
            common.set_conv_transpose_impl("native")
            ref = torch.nn.functional.conv_transpose2d(x.float(), wt.float(), bias.float(),
                                                       stride=2)
            row = {"x": list(xs), "w": list(ws)}
            for impl in ("native", "einsum"):
                common.set_conv_transpose_impl(impl)
                y = common.conv_transpose_2x2(x, wt, bias)
                row[f"{impl}_err"] = float((y.float() - ref).abs().max())
                row[f"{impl}_ms"] = timer.ms(lambda: common.conv_transpose_2x2(x, wt, bias))
            up_rows.append(row)
            del x, wt, bias, ref, y
    finally:
        common.set_conv_transpose_impl("native")
    log(f"[surface] Predictor under einsum ConvTranspose vs native (304² bf16, B={SERVE_B}): "
        f"argmax agreement {agree:.6f}")
    log(f"[surface] the 5 Upsampling ConvTransposes of a 304² B=8 bf16 forward, ms (L2 flushed) "
        f"native / einsum, on {smi}: "
        + "; ".join(f"{r['x']} -> {r['w'][1]}: {r['native_ms']:.4f} / {r['einsum_ms']:.4f} "
                    f"(max |err| vs float32 {r['native_err']:.2g} / {r['einsum_err']:.2g})"
                    for r in up_rows)
        + f"; summed {sum(r['native_ms'] for r in up_rows):.4f} / "
          f"{sum(r['einsum_ms'] for r in up_rows):.4f}")
    summary["conv_transpose"] = {"agreement": agree, "upsampling": up_rows}
    # 11.4 float16 serving: the decoder epilogue kernel in float16 on the
    # Predictor's path (the committed weights cast to float16)
    f16_pred = Predictor(weights, dtype=torch.float16)
    probs16 = counted("Predictor(dtype=float16) __call__", lambda: f16_pred(images),
                      {"aag": 0, "decoder_epilogue": 5, "bn_act": BN_SITES})
    agree16 = float((probs16.argmax(-1) == single.argmax(-1)).mean())
    check(bool(np.isfinite(probs16).all()) and agree16 >= MASK_AGREEMENT_FLOOR,
          f"float16 Predictor: argmax agreement {agree16} with bf16")
    log(f"[surface] Predictor(dtype=float16) (304², B={SERVE_B}): argmax agreement with bf16 "
        f"{agree16:.6f} (floor {MASK_AGREEMENT_FLOOR})")
    summary["f16_serving_agreement"] = agree16
    del f16_pred
    log(json.dumps({"surface": summary}))
    return paths


# bench-phase bounds: the k = 4 dispatch's first batch against one call on
# the same Predictor and input (the forwards differ only in which buffers
# the allocator hands them)
BENCH_DISPATCH_AGREEMENT = 0.9999
BENCH_KEYS = {"metric", "value", "unit", "per_call_img_s", "int8_mask_agreement", "device"}


def phase_bench(torch, smi):
    """Phase 12: `octave_tpu_torch.bench.main()` in process at its defaults
    (B = 256, 304², k = 4, the committed weights, CUDA), with the launch
    counts zeroed just before it; then, on the Predictor it served, the
    k = 4 dispatch against one call. Returns the launches by path."""
    from octave_tpu_torch import bench
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels import launch_counts

    out = io.StringIO()
    launch_counts(reset=True)
    quant.int8_mm.launches = 0
    with contextlib.redirect_stdout(out):
        run = bench.main()
    torch.cuda.synchronize()
    counts, gemms = launch_counts(), quant.int8_mm.launches
    printed = out.getvalue().splitlines()
    check(len(printed) == 1, f"bench printed {len(printed)} lines, expected one JSON line")
    record = json.loads(printed[0])
    # the record's rates are the benchmark's to read (h100bench/)
    log("[bench] record: " + json.dumps({k: v for k, v in record.items()
                                         if k not in ("value", "per_call_img_s")}))
    # one calibration forward, two gate forwards, 8 per-call forwards and 7
    # dispatches of k forwards, 5 epilogues each; the int8 conv kernel 25
    # times in each int8 forward: the gate's one and, if the int8 Predictor
    # serves, the 8 + 7 k timed ones (no library int8 GEMM)
    agreement = record["int8_mask_agreement"]
    int8_served = run.served is run.int8
    check(int8_sites(run.int8) == 25, f"the bench's int8 Predictor has {int8_sites(run.int8)} "
          f"int8 convs, expected 25")
    want = launches_of({"decoder_epilogue": 5 * (1 + 2 + 8 + 7 * BENCH_K),
                        "bn_act": BN_SITES * (1 + 2 + 8 + 7 * BENCH_K),
                        "int8_conv": 25 * (1 + (8 + 7 * BENCH_K) * int8_served)})
    log(f"[bench] launches {counts} (expected {want}), library int8 GEMMs {gemms}")
    check(counts == want and gemms == 0, f"bench launches {counts} and {gemms} library int8 "
          f"GEMMs, expected {want} and 0")
    check(set(record) == BENCH_KEYS, f"bench record keys {sorted(record)}")
    check(record["device"] == smi, f"bench device {record['device']!r}, nvidia-smi {smi!r}")
    check(int8_served == (agreement >= bench.AGREEMENT_GATE)
          and ("int8 dense-lowered decoder" in record["metric"]) == int8_served,
          f"gate: agreement {agreement}, int8 served {int8_served}, {record['metric']}")
    served = ("int8 (prepacked, dense-lowered decoder)" if int8_served
              else "bf16: the agreement gate fell back")
    log(f"[bench] served: {served}; int8/bf16 argmax agreement {agreement} "
        f"(gate {bench.AGREEMENT_GATE})")
    check(record["value"] > 0 and record["per_call_img_s"] > 0, "bench rates")

    pred = run.served
    xs = torch.from_numpy(run.images).to(pred.device, pred.dtype)
    xk = xs.unsqueeze(0).expand(BENCH_K, *xs.shape).contiguous()
    one = pred.predict_many_device(xs[None]).tensor[0]
    first = pred.predict_many_device(xk).tensor[0]
    agree = float((first.argmax(-1) == one.argmax(-1)).float().mean())
    diff = float((first - one).abs().max())
    log(f"[bench] k={BENCH_K} dispatch's first batch against one call (served Predictor, "
        f"B={BENCH_B}): argmax agreement {agree:.6f} (floor {BENCH_DISPATCH_AGREEMENT}), "
        f"max |prob diff| {diff:.3g}")
    check(agree >= BENCH_DISPATCH_AGREEMENT, f"k={BENCH_K} dispatch disagrees with one call")
    del one, first, run, pred, xs, xk
    label = f"cli bench (B={BENCH_B}, k={BENCH_K})"
    return {name: {label: want[name]} for name in ("bn_act", "decoder_epilogue", "int8_conv")}


# graph-phase settings (phase 13). The bit-for-bit cases: float32, TF32 off,
# deterministic algorithms, noise on, B = 2 at GRAPH_HW² (the main critic's
# depth 4 needs 32 to divide it), a schedule that decays over GRAPH_DECAY
# steps (every update takes another rate), GRAPH_CALLS calls of k steps.
GRAPH_HW = 128
GRAPH_CALLS = 4
GRAPH_DECAY = 8
# AAG launches per step: the gates of each architecture, twice where the
# remat region holds them (the recompute runs them again)
GRAPH_AAG = {"unet": 5, "parallel_head_gate": 7}
GRAPH_REMAT = (True, "conv", "block", "block-enc", "block:012", "block:01e34", "block:012+conv")
# calls of the second graphed Trainer.fit of 13.4: replays inside the window
# its peak memory is read over
FIT_CALLS = 6
# C.8: a conv's sample std against sqrt(2/(kh kw out)), in standard errors
# (1/sqrt(2n) relative for n draws), as tests/test_torch_init.py holds it
C8_Z = 6.0


def phase_graph(torch, smi):
    """Phase 13: the train step as one CUDA-graph replay per call. Returns
    {kernel: {path: launches}} of its graphed runs."""
    tmp = tempfile.mkdtemp(prefix="octave_graph_")
    try:
        with cached_datasets():
            return _graph(torch, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def cached_datasets():
    """Every `Trainer.fit` inside reads one dataset object per (config,
    split): the synthetic phantoms are generated once, not in each fit's
    first epoch (~0.2 s per 304² phantom on the host). The phantoms are the
    same either way."""
    from octave_tpu_torch.train import trainer

    build, made = trainer.build_dataset, {}

    def build_once(cfg, split="train"):
        d = cfg.data
        key = (d.dataset, tuple(d.image_size), d.synthetic_n, d.root, cfg.train.seed, split)
        if key not in made:
            made[key] = build(cfg, split)
        return made[key]

    trainer.build_dataset = build_once
    try:
        yield
    finally:
        trainer.build_dataset = build


def _graph(torch, smi, tmp):
    import math
    import warnings

    from octave_tpu_torch.data import datasets as ds
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.train.steps import GraphedStep
    from octave_tpu_torch.train.trainer import Trainer, build_dataset
    from octave_tpu_torch.utils.checkpoint import state_to_dict
    from octave_tpu_torch.utils.config import Config

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}}
    summary = {"device": smi}

    # 13.1 C.8 on the card: a fresh ResnestUNet's backbone convs
    torch.manual_seed(0)
    seg = ResnestUNet(2).cuda()
    ratios, worst, splat = [], 0.0, []
    for name, w in seg.state_dict().items():
        if name.startswith("encoder_") and w.ndim == 4:
            r = float(w.std()) / math.sqrt(2.0 / (w.shape[2] * w.shape[3] * w.shape[0]))
            ratios.append(r)
            worst = max(worst, abs(r - 1) * math.sqrt(2 * w.numel()))
        elif name.startswith("decoder_") and ".conv.3." in name and w.ndim == 4:
            splat.append(float(w.std()) * math.sqrt(3 * w[0].numel()))  # kaiming-uniform: 1
    log(f"[graph] C.8: the {len(ratios)} backbone convs of a fresh ResnestUNet (seed 0) on the "
        f"card: std / sqrt(2/(kh kw out)) {min(ratios):.4f}-{max(ratios):.4f}, at most "
        f"{worst:.2f} standard errors from 1 (bound {C8_Z}); the decoders' {len(splat)} "
        f"split-attention convs keep torch's kaiming-uniform: std / (1/sqrt(3 fan_in)) "
        f"{min(splat):.4f}-{max(splat):.4f}")
    check(len(ratios) == 87 and worst <= C8_Z, f"C.8: backbone conv stds {worst:.2f} "
          "standard errors from the ResNet init")
    summary["c8"] = {"convs": len(ratios), "ratio_min": min(ratios), "ratio_max": max(ratios),
                     "worst_standard_errors": worst}
    del seg

    # 13.2 graphed against eager, bit for bit
    def run(arch, graphed, k, calls=GRAPH_CALLS, **extra):
        """Trainer.fit of `calls` calls of k steps from train.seed: (state,
        each call's logged losses, AAG launches)."""
        logs = tempfile.mkdtemp(dir=tmp)
        cfg = Config().apply_overrides({
            "data.image_size": f"[{GRAPH_HW},{GRAPH_HW}]", "data.batch_size": "2",
            "data.synthetic_n": "8", "model.architecture": arch,
            "optim.decay_steps": str(GRAPH_DECAY), "train.steps_per_call": str(k),
            "train.steps": str(k * calls), "train.log_every": str(k), "train.log_dir": logs,
            "train.eval_every": "0", **extra})
        tr = Trainer(cfg, device="cuda", graphed=graphed)
        launch_counts(reset=True)
        state = tr.fit()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts["bn_act"] == 0, f"{arch} fit: {counts['bn_act']} fused batch norms")
        n = counts["aag"]
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            losses = [{k_: v for k_, v in json.loads(line).items() if k_.startswith("train/loss")}
                      for line in f]
        return state, losses, n

    def differences(got, want):
        """(largest |difference| over every leaf of the two states, leaves,
        the leaves that differ)."""
        a, b = dict(leaves(state_to_dict(got))), dict(leaves(state_to_dict(want)))
        check(a.keys() == b.keys(), "the two states hold other entries")
        worst_, bad = 0.0, []
        for key, v in b.items():
            u = a[key]
            if torch.is_tensor(v):
                if not torch.equal(u, v):
                    bad.append(key)
                    worst_ = max(worst_, float((u.double() - v.double()).abs().max()))
            elif u != v:
                bad.append(key)
                worst_ = math.inf
        return worst_, len(b), bad

    def loss_gap(got, want):
        check(len(got) == len(want), f"logged calls {len(got)} and {len(want)}")
        return max(abs(g[key] - w[key]) for g, w in zip(got, want) for key in w)

    def hold(label, arch, k, calls=GRAPH_CALLS, **extra):
        eager, l_eager, n_eager = run(arch, False, k, calls, **extra)
        graph, l_graph, n_graph = run(arch, True, k, calls, **extra)
        check(eager.graph is None and isinstance(graph.graph, GraphedStep)
              and graph.graph.graph is not None and graph.graph.calls == calls,
              f"{label}: the graphed run captured no graph")
        per_step = GRAPH_AAG[arch] * (2 if extra.get("train.remat") in ("true", "conv") else 1)
        want_n = per_step * k * calls
        check(n_eager == n_graph == want_n, f"{label}: AAG launches eager {n_eager}, graphed "
              f"{n_graph}, expected {want_n}")
        d_state, n_leaves, bad = differences(graph, eager)
        d_loss = loss_gap(l_graph, l_eager)
        row = {"k": k, "calls": calls, "loss_diff": d_loss, "state_diff": d_state,
               "leaves": n_leaves, "aag_launches": n_graph}
        text = "bit for bit" if not (bad or d_loss) else \
            f"max |loss diff| {d_loss:.3g}, max |state diff| {d_state:.3g} in {len(bad)} leaves"
        if bad or d_loss:
            again, l_again, _ = run(arch, False, k, calls, **extra)
            s_state, _, s_bad = differences(again, eager)
            s_loss = loss_gap(l_again, l_eager)
            row.update(spread_loss=s_loss, spread_state=s_state)
            text += (f"; eager against eager from the same start: max |loss diff| {s_loss:.3g}, "
                     f"max |state diff| {s_state:.3g} in {len(s_bad)} leaves")
            check((s_bad or s_loss) and d_loss <= s_loss and d_state <= s_state,
                  f"{label}: graphed against eager ({text}; first {bad[:4]}) outside the "
                  "eager-against-eager spread")
        log(f"[graph] {label}, float32 {GRAPH_HW}² B=2, noise on, {calls} calls: graphed "
            f"against eager {text} over {len(l_graph)} calls' losses and {n_leaves} state leaves "
            f"(parameters, BN statistics, spectral u/v, moments, schedule, generator); AAG "
            f"launches {n_graph} ({per_step} per step through the replays)")
        paths["aag"][f"graphed Trainer.fit, {label}, {calls} calls"] = n_graph
        return row, graph, l_graph

    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    bits = {}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = None
            for arch in ("unet", "parallel_head_gate"):
                for k in (1, 2, 4):
                    bits[f"{arch} k={k}"], state, losses = hold(f"{arch} k={k}", arch, k)
                    if arch == "unet" and k == 1:
                        straight = state, losses
                    del state
            bits["unet moment bf16 k=2"], _, _ = hold(
                "unet, MomentAdam (optim.moment_dtype=bfloat16), k=2", "unet", 2,
                **{"optim.moment_dtype": "bfloat16"})
            for mode in GRAPH_REMAT:
                bits[f"unet remat={mode}"], _, _ = hold(
                    f"unet remat={mode!r} k=1", "unet", 1, calls=2,
                    **{"train.remat": str(mode).lower()})

            # 13.3 the graphed resume: fit to step 2, then a resume to step 4,
            # against the graphed fit to step 4 (unet k=1 above)
            ckpt = os.path.join(tmp, "resume")
            first, _, _ = run("unet", True, 1, calls=2, **{"train.checkpoint_dir": ckpt})
            check(first.step == 2 and first.graph.graph is not None, "the fit to step 2")
            del first
            resumed, l_resumed, _ = run("unet", True, 1, calls=4, **{"train.checkpoint_dir": ckpt})
            d_state, n_leaves, bad = differences(resumed, straight[0])
            d_loss = loss_gap(l_resumed, straight[1][2:])
            log(f"[graph] graphed fit to step 2 (captured at call 2), then resumed to step 4 "
                f"(captured anew at call 4) against the graphed fit to step 4: "
                f"{len(bad)} of {n_leaves} state leaves differ (largest {d_state:.3g}), calls "
                f"3-4's losses differ by {d_loss:.3g}")
            check(not bad and not d_loss and resumed.step == 4,
                  f"graphed resume differs in {bad[:4]}, losses {d_loss}")
            summary["resume_leaves_differing"] = len(bad)
            del resumed, straight
        nondeterministic = sorted({str(w.message).split(".")[0][:120] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.allow_tf32 = True
    log(f"[graph] ops without a deterministic variant in these runs: "
        f"{nondeterministic or 'none'}")
    summary["bit_for_bit"] = bits
    summary["nondeterministic_ops"] = nondeterministic
    torch.cuda.empty_cache()

    # 13.4 at 304², B = 8, bf16, default Config: eager and graphed calls'
    # launches; the graphed Trainer.fit's peak memory at k = 1, 2, 4
    fit_peak_gib = {}
    for arch in ("unet", "parallel_head_gate"):
        over = {"data.synthetic_n": "8", "train.compute_dtype": "bfloat16",
                "train.eval_every": "0", "train.log_every": "0", "model.architecture": arch}
        host = next(ds.batch_iterator(build_dataset(Config().apply_overrides(over)), 8, seed=0))
        states, runs, batches = {}, {}, {}
        for mode in ("eager", "graphed"):
            tr = Trainer(Config().apply_overrides(over), device="cuda",
                         graphed=mode == "graphed")
            states[mode] = state = tr.init_state()
            runs[mode] = run_call = tr.step_call(state)
            batches[mode] = tr.call_batch([host], 0)
            for _ in range(3):  # the graphed: warm-up, capture, replay
                run_call(state, batches[mode])
        check(isinstance(runs["graphed"], GraphedStep) and runs["graphed"].graph is not None,
              f"{arch}: the graphed step was not captured")
        for mode in ("eager", "graphed"):
            launch_counts(reset=True)
            runs[mode](states[mode], batches[mode])
            torch.cuda.synchronize()
            counts = launch_counts()
            check(counts["bn_act"] == 0, f"{arch} {mode}: {counts['bn_act']} fused batch norms")
            launched = counts["aag"]
            check(launched == GRAPH_AAG[arch], f"{arch} {mode}: {launched} AAG launches in "
                  f"one call, expected {GRAPH_AAG[arch]}")
            log(f"[graph] {arch} bf16 step, 304², B=8, {mode}: {launched} AAG launches in one "
                f"call")

        # the graphed Trainer.fit at steps_per_call 1, 2, 4: a fit of 2 calls
        # (warm-up, capture), then a fit of FIT_CALLS more on the state
        fit_peaks = {}
        for k in (1, 2, 4):
            state = states["graphed"]
            tr = Trainer(Config().apply_overrides(
                {**over, "train.steps_per_call": str(k), "train.steps": str(state.step + 2 * k)}),
                device="cuda", graphed=True)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr.fit(state)
            tr.cfg.train.steps = state.step + FIT_CALLS * k
            tr.fit(state)
            torch.cuda.synchronize()
            fit_peaks[f"graphed k={k}"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        log(f"[graph] {arch} graphed Trainer.fit (304², B=8, bf16, {FIT_CALLS} calls after a fit "
            f"of 2): peak above the state's resident memory (GiB) "
            + "; ".join(f"{key} {v:.2f}" for key, v in fit_peaks.items()))
        for k in (2, 4):
            check(fit_peaks[f"graphed k={k}"] <= 1.25 * fit_peaks["graphed k=1"],
                  f"{arch}: {k} steps in one graph peak at {fit_peaks[f'graphed k={k}']:.2f} GiB, "
                  f"one step's graph at {fit_peaks['graphed k=1']:.2f}")
        fit_peak_gib[arch] = fit_peaks
        del states, runs, batches, state, tr
        torch.cuda.empty_cache()
    summary["fit_peak_gib"] = fit_peak_gib
    log(json.dumps({"graph": summary}))
    return paths


# graphed-serving settings (phase 14). The float32 bit-for-bit cases run at
# 304², B = GRAPHED_B; the dtypes and the server at SERVE_B.
GRAPHED_B = 8
GRAPHED_FLOOD = 1280
# graphed against eager in bf16, float16 and int8: the same kernels on the
# same inputs, so any difference is the device's own order of work
GRAPHED_AGREEMENT = 0.999
# Trainer.evaluate, float32: GRAPH_HW², B = 2 over 5 test phantoms (a ragged
# last batch of 1)
EVAL_N = 5


def phase_graphed(torch, smi, weights, images):
    """Phase 14: serving and evaluation as CUDA-graph replays. Returns
    {kernel: {path: launches}} of its graphed runs."""
    tmp = tempfile.mkdtemp(prefix="octave_graphed_")
    try:
        with cached_datasets():
            return _graphed(torch, smi, weights, images, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _graphed(torch, smi, weights, images, tmp):
    import warnings

    import numpy as np

    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels import launch_counts
    from octave_tpu_torch.serve import BatchServer, Predictor
    from octave_tpu_torch.train import trainer as trainer_mod
    from octave_tpu_torch.train.trainer import Trainer
    from octave_tpu_torch.utils.checkpoint import CheckpointManager
    from octave_tpu_torch.utils.config import Config

    paths = {"aag": {}, "bn_act": {}, "decoder_epilogue": {}, "int8_conv": {}}
    summary = {"device": smi}
    dev0 = torch.device("cuda", 0)

    def twins(**kw):
        """(eager, graphed) Predictors of one configuration."""
        return Predictor(weights, graphed=False, **kw), Predictor(weights, **kw)

    def counted(fn):
        """(fn(), {kernel: launches}) with the counts zeroed just before fn
        and read just after; no library int8 GEMM may run."""
        launch_counts(reset=True)
        quant.int8_mm.launches = 0
        out = fn()
        torch.cuda.synchronize()
        check(quant.int8_mm.launches == 0, f"{quant.int8_mm.launches} library int8 GEMMs")
        return out, launch_counts()

    def held(label, eager_fn, graphed_fn, per_call, exact=True, floor=GRAPHED_AGREEMENT):
        """eager_fn() once against graphed_fn() at its warm-up, capture and
        replay: bit for bit (exact) or argmax agreement >= floor; the same
        launch counts, `per_call` of them (the int8 conv kernel's among
        them). Returns (graphed output, its counts, the largest
        |difference|)."""
        per_call = launches_of(per_call)
        want, n_eager = counted(eager_fn)
        check(n_eager == per_call, f"{label}: eager counts {n_eager}, expected {per_call}")
        worst, low = 0.0, 1.0
        for call in ("warm-up", "capture", "replay"):
            got, n = counted(graphed_fn)
            check(n == n_eager, f"{label} {call}: counts {n} graphed, {n_eager} eager")
            diff = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
            agree = float((got.argmax(-1) == want.argmax(-1)).mean())
            worst, low = max(worst, diff), min(low, agree)
            if exact:
                check(np.array_equal(got, want), f"{label} {call}: graphed differs from eager "
                      f"by {diff:.3g}")
            else:
                check(agree >= floor, f"{label} {call}: argmax agreement {agree} < {floor}")
        log(f"[graphed] {label}: graphed (warm-up, capture, replay) against eager: "
            + ("bit for bit" if exact else f"argmax agreement >= {low:.6f}")
            + f", max |diff| {worst:.3g}; counts per call {n} through the replays")
        return got, n, worst, low

    # 14.1 float32 (TF32 off, deterministic algorithms): graphed equals eager
    # bit for bit, __call__ and predict_many at k = 1, 2, 4, fused and
    # unfused; 14.3 the mesh; 14.4 no result overwritten; 14.6 evaluate
    x8 = images[:GRAPHED_B]
    stacks = {k: np.stack([np.roll(x8, i, axis=0) for i in range(k)]) for k in (1, 2, 4)}
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    bits = {}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for fused, kernel in ((True, "decoder_epilogue"), (False, "aag")):
                name = "fused" if fused else "unfused"
                eager, graphed = twins(dtype=torch.float32, use_fused_decoder=fused)
                zero = launches_of({})
                for k, stack in stacks.items():
                    label = f"float32 {name} predict_many k={k} (304², B={GRAPHED_B})"
                    held(label, lambda: eager.predict_many(stack),
                         lambda: graphed.predict_many(stack),
                         {**zero, kernel: 5 * k, "bn_act": BN_SITES * k})
                    paths[kernel][f"graphed Predictor, {label}"] = 5 * k
                    paths["bn_act"][f"graphed Predictor, {label}"] = BN_SITES * k
                held(f"float32 {name} __call__ (the k=1 graph)", lambda: eager(x8),
                     lambda: graphed(x8), {**zero, kernel: 5, "bn_act": BN_SITES})
                check(graphed.captures == 3, f"{name}: {graphed.captures} captures, expected 3")
                bits[name] = {"ks": [1, 2, 4], "captures": graphed.captures}
                if fused:
                    # 14.4 two stacks dispatched back to back, downloaded in
                    # the other order
                    a, b = stacks[2], stacks[2][:, ::-1].copy()
                    ra, rb = graphed.predict_many_device(a), graphed.predict_many_device(b)
                    got_b, got_a = np.asarray(rb), np.asarray(ra)
                    check(np.array_equal(got_a, eager.predict_many(a))
                          and np.array_equal(got_b, eager.predict_many(b))
                          and not np.array_equal(got_a, got_b),
                          "a back-to-back dispatch's result was overwritten")
                    log("[graphed] two predict_many_device stacks (k=2) dispatched back to "
                        "back without a wait, downloaded in the other order: each equals its "
                        "own eager result bit for bit")
                    # a fresh Predictor's k = 1 graph captured, then without a
                    # wait an unseen k (its eager warm-up runs in the pool the
                    # k = 1 graph reuses at every replay) and a k = 1 replay
                    fresh = Predictor(weights, dtype=torch.float32)
                    fresh.warmup(GRAPHED_B, (304, 304), ks=(1,))
                    other = stacks[1][:, ::-1].copy()
                    rk, r1 = fresh.predict_many_device(stacks[4]), fresh.predict_many_device(other)
                    got_k, got_1 = np.asarray(rk), np.asarray(r1)
                    check(np.array_equal(got_k, eager.predict_many(stacks[4]))
                          and np.array_equal(got_1, eager.predict_many(other))
                          and fresh.captures == 1,
                          "an unseen k's warm-up result beside a k=1 replay was overwritten")
                    log("[graphed] the k=1 graph captured, then without a wait k=4 (its eager "
                        "warm-up in the graphs' pool) and a k=1 replay of other images: each "
                        "equals its own eager result bit for bit")
                    del fresh
                del eager, graphed
            # 14.3 Predictor(mesh=(cuda:0, cuda:0)) against its eager self
            eager, graphed = twins(dtype=torch.float32, mesh=(dev0, dev0))
            per = launches_of({"decoder_epilogue": 2 * 5 * 2, "bn_act": 2 * BN_SITES * 2})
            held("float32 Predictor(mesh=(cuda:0, cuda:0)) predict_many k=2",
                 lambda: eager.predict_many(stacks[2]), lambda: graphed.predict_many(stacks[2]),
                 per)
            held("float32 Predictor(mesh=(cuda:0, cuda:0)) __call__", lambda: eager(x8),
                 lambda: graphed(x8), {**per, "decoder_epilogue": 10, "bn_act": 2 * BN_SITES})
            check(graphed.captures == 4, f"mesh: {graphed.captures} captures, expected 2 x 2")
            paths["decoder_epilogue"]["graphed Predictor(mesh=(cuda:0, cuda:0)), k=2"] = 20
            paths["bn_act"]["graphed Predictor(mesh=(cuda:0, cuda:0)), k=2"] = 4 * BN_SITES
            bits["mesh"] = {"captures": graphed.captures}
            del eager, graphed
            torch.cuda.empty_cache()

            # 14.6 Trainer.evaluate graphed against eager: counts as integers
            recorded = []
            unpack = trainer_mod.unpack_counts

            def recording(packed):
                recorded.append(np.array(packed))
                return unpack(packed)

            trainer_mod.unpack_counts = recording
            eval_rows = {}
            try:
                for arch, per_batch in GRAPH_AAG.items():
                    over = {"data.image_size": f"[{GRAPH_HW},{GRAPH_HW}]",
                            "data.batch_size": "2", "data.synthetic_n": str(EVAL_N),
                            "model.architecture": arch, "train.steps": "1",
                            "train.eval_every": "0", "train.log_every": "0"}
                    eager_tr = Trainer(Config().apply_overrides(over), device="cuda",
                                       graphed=False)
                    graph_tr = Trainer(Config().apply_overrides(over), device="cuda")
                    state = graph_tr.init_state()

                    def pair(label):
                        del recorded[:]
                        want = eager_tr.evaluate(state)
                        n_want = len(recorded)
                        launch_counts(reset=True)
                        got = graph_tr.evaluate(state)
                        torch.cuda.synchronize()
                        counts = launch_counts()
                        check(counts["bn_act"] == 0, f"{arch} {label}: {counts['bn_act']} fused "
                              "batch norms in an unfolded evaluate")
                        n_aag = counts["aag"]
                        e, g = recorded[:n_want], recorded[n_want:]
                        check(len(e) == len(g) == 3 and all(np.array_equal(x, y)
                                                            for x, y in zip(e, g)),
                              f"{arch} {label}: graphed eval counts differ from eager")
                        check(got == want, f"{arch} {label}: metrics {got} against {want}")
                        check(n_aag == per_batch * 3, f"{arch} {label}: {n_aag} AAG launches, "
                              f"expected {per_batch} per batch")
                        return got, n_aag

                    for label in ("warm-up", "capture", "replay"):
                        got, n_aag = pair(label)
                    graphs = state.eval_graphs
                    check(graphs is not None and graphs.captures == 2,
                          f"{arch}: eval graphs {graphs and graphs.captures}, expected 2 "
                          "(B = 2 and the ragged B = 1)")
                    ckpt = CheckpointManager(os.path.join(tmp, f"ckpt_{arch}"))
                    ckpt.save(0, state)
                    ckpt.wait()
                    graph_tr.fit(state)  # one graphed-trainer step: weights move in place
                    check(state.step == 1 and state.eval_graphs is graphs,
                          f"{arch}: the fit replaced the eval graphs")
                    after, _ = pair("after a fit step")
                    check(after != got, f"{arch}: the fit step did not move the metrics")
                    ckpt.restore_latest(state)
                    ckpt.close()
                    check(state.eval_graphs is None and state.step == 0,
                          f"{arch}: the restore kept the eval graphs")
                    for label in ("warm-up after a restore", "capture after a restore"):
                        restored, _ = pair(label)
                    check(restored == got, f"{arch}: restored metrics {restored} against {got}")
                    eval_rows[arch] = {"metrics": got, "after_fit": after,
                                       "aag_per_evaluate": n_aag}
                    paths["aag"][f"graphed Trainer.evaluate, {arch}, float32 {GRAPH_HW}², "
                                 f"3 batches"] = n_aag
                    log(f"[graphed] Trainer.evaluate {arch} float32 {GRAPH_HW}², {EVAL_N} "
                        f"phantoms in batches of 2 (ragged last batch of 1): graphed equals "
                        f"eager in every batch's confusion counts and ROC histograms (integers) "
                        f"and in Dice/AUC at the warm-up, the captures, a replay, after a fit "
                        f"step (weights moved in place: dice {got['dice']:.6f} -> "
                        f"{after['dice']:.6f}) and after a restore (the graphs dropped and "
                        f"captured anew); {n_aag} AAG launches per evaluate "
                        f"({per_batch} per batch through the replays)")
                    del eager_tr, graph_tr, state, graphs
            finally:
                trainer_mod.unpack_counts = unpack
        nondeterministic = sorted({str(w.message).split(".")[0][:120] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.allow_tf32 = True
    summary["bit_for_bit"] = bits
    summary["evaluate"] = eval_rows
    summary["nondeterministic_ops"] = nondeterministic
    log(f"[graphed] ops without a deterministic variant: {nondeterministic or 'none'}")
    torch.cuda.empty_cache()

    # 14.2 bf16 (the default), float16 and int8 (decoder, prepacked): graphed
    # against eager, and the floors against float32 and bf16
    plain = Predictor(weights, dtype=torch.float32, graphed=False)
    torch.backends.cudnn.allow_tf32 = False
    ref32 = plain(images)
    torch.backends.cudnn.allow_tf32 = True
    del plain
    stack2 = np.stack([images, images[::-1]])
    variants = {}
    for name, kw in (("bf16", {}), ("float16", {"dtype": torch.float16}),
                     ("int8", {"int8_decoder": True,
                               "calibration_batches": [phantoms(SERVE_B, 304, seed=31)]})):
        eager, graphed = twins(**kw)
        convs = int8_sites(graphed)
        check(convs == (25 if name == "int8" else 0), f"{name}: {convs} int8 convs")
        probs, _, worst, low = held(f"{name} __call__ (304², B={SERVE_B})", lambda: eager(images),
                                    lambda: graphed(images),
                                    {"decoder_epilogue": 5, "int8_conv": convs, "bn_act": BN_SITES},
                                    exact=False)
        _, _, worst2, low2 = held(f"{name} predict_many k=2", lambda: eager.predict_many(stack2),
                                  lambda: graphed.predict_many(stack2),
                                  {"decoder_epilogue": 10, "int8_conv": 2 * convs,
                                   "bn_act": 2 * BN_SITES}, exact=False)
        paths["decoder_epilogue"][f"graphed Predictor, {name} __call__ (B={SERVE_B})"] = 5
        paths["bn_act"][f"graphed Predictor, {name} __call__ (B={SERVE_B})"] = BN_SITES
        if convs:
            paths["int8_conv"][f"graphed Predictor, {name} __call__ (B={SERVE_B})"] = convs
        variants[name] = {"agreement": min(low, low2), "max_abs_diff": max(worst, worst2),
                          "int8_convs_per_call": convs, "probs": probs}
        if name == "bf16":
            serving = (eager, graphed)  # kept for the server below
        del eager, graphed
    mask32 = ref32[..., 1] >= 0.5
    floors = {
        "bf16 mask vs float32": float(((variants["bf16"]["probs"][..., 1] >= 0.5) == mask32)
                                      .mean()),
        "float16 mask vs float32": float(((variants["float16"]["probs"][..., 1] >= 0.5)
                                          == mask32).mean()),
        "int8 argmax vs bf16": float((variants["int8"]["probs"].argmax(-1)
                                      == variants["bf16"]["probs"].argmax(-1)).mean()),
    }
    log(f"[graphed] floors held by the graphed Predictors (304², B={SERVE_B}): "
        + ", ".join(f"{k} {v:.6f}" for k, v in floors.items())
        + f" (floors {MASK_AGREEMENT_FLOOR}, {MASK_AGREEMENT_FLOOR}, {INT8_AGREEMENT_FLOOR})")
    check(floors["bf16 mask vs float32"] >= MASK_AGREEMENT_FLOOR
          and floors["float16 mask vs float32"] >= MASK_AGREEMENT_FLOOR
          and floors["int8 argmax vs bf16"] >= INT8_AGREEMENT_FLOOR, f"floors {floors}")
    for v in variants.values():
        del v["probs"]
    summary["variants"], summary["floors"] = variants, floors
    del ref32

    eager, graphed = serving
    preds = {"eager": eager, "graphed": graphed}

    # 14.5 BatchServer over the graphed Predictor: a flood of GRAPHED_FLOOD
    # against the eager server's, no capture after warmup; a server without
    # warm-up captures in its worker
    base = phantoms(64, 304, seed=12)
    flood = [np.roll(base[i % 64], i, axis=1) for i in range(GRAPHED_FLOOD)]  # all distinct
    servers = {mode: BatchServer(p, batch=SERVE_B, image_hw=(304, 304), ks=(1, 2, 4))
               for mode, p in preds.items()}
    dispatched = []
    dispatch = graphed.predict_many_device
    graphed.predict_many_device = lambda stack: (dispatched.append(stack.shape[0]),
                                                 dispatch(stack))[1]
    try:
        after_warmup = graphed.captures
        outs = {}
        for mode in ("graphed", "eager"):
            launch_counts(reset=True)
            outs[mode] = np.stack(list(servers[mode].map(iter(flood))))
            torch.cuda.synchronize()
            if mode == "graphed":
                counts = launch_counts()
                flood_launches = counts["decoder_epilogue"]
                check(flood_launches == 5 * sum(dispatched)
                      and counts["bn_act"] == BN_SITES * sum(dispatched)
                      and sum(dispatched) * SERVE_B >= GRAPHED_FLOOD,
                      f"graphed flood: {flood_launches} epilogue and {counts['bn_act']} fused "
                      f"batch norm launches, dispatched k {dispatched}")
        diff = float(np.abs(outs["graphed"] - outs["eager"]).max())
        check(np.array_equal(outs["graphed"], outs["eager"]),
              f"graphed flood differs from the eager server's by {diff}")
        check(graphed.captures == after_warmup, f"the flood captured "
              f"{graphed.captures - after_warmup} graphs after warmup")
        del outs
        # two more floods and ten lone requests (k = 1) through the graphed server
        for _ in range(2):
            sum(1 for _ in servers["graphed"].map(iter(flood)))
        for img in flood[:10]:
            servers["graphed"].submit(img).result(timeout=120)
        check(graphed.captures == after_warmup, "the later floods captured")
    finally:
        for srv in servers.values():
            srv.close()
        del graphed.predict_many_device
    log(f"[graphed] BatchServer flood of {GRAPHED_FLOOD} (304² bf16, B={SERVE_B}, ks (1,2,4)) "
        f"over the graphed Predictor: every result equal to the eager server's (max |diff| "
        f"{diff:.3g}); {flood_launches} epilogue launches through the replays (5 x the sum of "
        f"the dispatched k); {after_warmup} graphs captured by warmup, none after it in three "
        f"floods and 10 lone requests")
    paths["decoder_epilogue"][f"graphed BatchServer flood of {GRAPHED_FLOOD}"] = flood_launches
    fresh = Predictor(weights)
    n_worker = 8 * SERVE_B
    with BatchServer(fresh, batch=SERVE_B, image_hw=(304, 304), ks=(1, 2, 4),
                     warmup=False) as srv:
        for _ in range(3):
            got = np.stack(list(srv.map(iter(flood[:n_worker]))))
            check(np.array_equal(got, np.concatenate([eager(np.stack(flood[i:i + SERVE_B]))
                                                      for i in range(0, n_worker, SERVE_B)])),
                  "a server capturing in its worker differs from the eager Predictor")
    check(fresh.captures >= 1, "the server without warm-up captured nothing in its worker")
    log(f"[graphed] BatchServer without warm-up: its worker captured {fresh.captures} graphs "
        f"(thread_local captures beside the resolver's downloads); three floods of {n_worker} "
        f"equal the eager Predictor bit for bit")
    summary["server"] = {"captures_after_warmup": graphed.captures - after_warmup,
                         "captured_in_worker": fresh.captures}
    del fresh, eager, graphed, serving, preds, servers
    torch.cuda.empty_cache()

    # 14.7 Trainer.evaluate over the default Config's synthetic test split
    # (304², B = 8, 64 phantoms, float32), graphed against eager
    over = {"train.eval_every": "0", "train.log_every": "0"}
    trainers = {"eager": Trainer(Config().apply_overrides(over), device="cuda", graphed=False),
                "graphed": Trainer(Config().apply_overrides(over), device="cuda")}
    state = trainers["graphed"].init_state()
    for tr in trainers.values():  # the phantoms generated; the graphed: warm-up, capture
        tr.evaluate(state)
    trainers["graphed"].evaluate(state)
    results = {mode: tr.evaluate(state) for mode, tr in trainers.items()}
    check(results["graphed"] == results["eager"], f"evaluate at 304²: graphed {results}")
    log(f"[graphed] Trainer.evaluate over the synthetic test split "
        f"({trainers['eager'].cfg.data.synthetic_n} phantoms, 304², B=8, float32, unet, the "
        f"phantoms cached): the graphed replay's metrics equal eager's")
    del trainers, state
    torch.cuda.empty_cache()
    log(json.dumps({"graphed": summary}))
    return paths


# int8-kernel-phase settings (phase 15): the card's published peaks the
# kernel's bound is taken against (NVIDIA H100 SXM: dense int8 tensor-core
# operations, device memory)
INT8_OPS_PER_S = 1979e12


def int8_site_bound(a, groups):
    """(bound ms, "bytes" or "operations", ops, bytes) of one int8 conv call
    (`a`: its arguments by name): the multiply-adds the conv needs (a
    grouped conv's, not the zeros of its block-diagonal operand) at the
    card's int8 rate, and each input read once (activations, the int8
    weight, scales, bias) and the output written once at its memory rate."""
    x, ws, bias, pair = a["x"], a["ws"], a["bias"], a["pair"]
    b, h, w, c = x.shape
    cout = ws.shape[0]
    kh, kw_ = a["kernel"]
    sources = [(x, c)] + ([(pair[0], pair[0].shape[3])] if pair is not None else [])
    if a["transpose"]:
        rows, n, out_hw = b * h * w, 4 * cout, (2 * h, 2 * w)
        k_true = [c]
    else:
        (sh, sw), (ph, pw), (dh, dw) = a["stride"], a["padding"], a["dilation"]
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw_ - 1) - 1) // sw + 1
        rows, n, out_hw = b * ho * wo, cout, (ho, wo)
        k_true = [kh * kw_ * cs // groups for _, cs in sources]
    ops = 2 * rows * n * sum(k_true)
    nbytes = sum(t.numel() * t.element_size() for t, _ in sources)
    nbytes += sum(n * k for k in k_true) + 4 * n * len(sources) + 4 * len(sources)
    nbytes += 0 if bias is None else bias.numel() * bias.element_size()
    nbytes += b * out_hw[0] * out_hw[1] * cout * x.element_size()
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", ops, nbytes) if t_ops >= t_bytes else (t_bytes, "bytes", ops,
                                                                         nbytes)


def phase_int8_kernel(torch, smi, weights, images):
    """Phase 15: the int8 conv kernel at the exact inputs of the int8
    Predictor's sites: every call of `int8_conv_nhwc` in one eager forward
    (scope decoder and scope all at B = SERVE_B; the bench's configuration
    at B = BENCH_B) recorded and held to the plain version on the same
    inputs, bit for bit; per decoder depth at both batches the kernel's,
    the plain version's and cuDNN's bf16 conv's times (the last a yardstick
    for another function: no quantisation) beside the bound, the path each
    site took (`int8_conv.path.*`) and, at the sites of the wide halo path,
    the halo kernel's time on the same inputs; the whole int8 forward of the
    graphed Predictor against a twin whose sites run the plain version
    (patched here only), bit for bit; at B = BENCH_B the six depth 2-4 sites
    on the wide path; the crossover table (`int8_crossover`). Returns the
    JSON line's int8_conv figures."""
    import inspect

    import numpy as np
    import torch.nn.functional as F

    from octave_tpu_torch import bench
    from octave_tpu_torch.ops import quant
    from octave_tpu_torch.ops.kernels.int8_conv import (
        PATHS,
        forced_path,
        int8_conv_nhwc_plain,
        path_counters,
    )
    from octave_tpu_torch.serve import Predictor

    timer = Timer(torch)
    kernel = quant.int8_conv_nhwc
    signature = inspect.signature(kernel)
    calib = phantoms(SERVE_B, 304, seed=31)

    def yardstick(mod, a):
        """ms of cuDNN's bf16 conv of the site's float shape (the pair's
        concat), on random bf16 values."""
        b, h, w, c = a["x"].shape
        c += a["pair"][0].shape[3] if a["pair"] is not None else 0
        xb = torch.randn(b, c, h, w, device="cuda", dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bias = None if a["bias"] is None else a["bias"].to(torch.bfloat16)
        cout = a["ws"].shape[0]
        if mod.transpose:
            wt = torch.randn(c, cout, 2, 2, device="cuda", dtype=torch.bfloat16)
            return timer.ms(lambda: F.conv_transpose2d(xb, wt, bias, stride=2))
        stride, padding, dilation = mod.geometry
        wt = torch.randn(cout, c // mod.groups, *mod.kernel, device="cuda", dtype=torch.bfloat16)
        return timer.ms(lambda: F.conv2d(xb, wt, bias, stride, padding, dilation, mod.groups))

    def run_sites(pred, x, timed):
        """One eager forward of `pred` on `x`, every int8 conv call's output
        held to the plain version's on the same inputs; rows per call."""
        rows, current = [], {}

        def forced_ms(path, args, kw):
            """ms of the kernel forced onto `path`, or None where that does
            not apply to the site."""
            try:
                with forced_path(path):
                    kernel(*args, **kw)
            except RuntimeError:
                return None
            with forced_path(path):
                return timer.ms(lambda: kernel(*args, **kw))

        def recorder(*args, **kw):
            before = {p: c.launches for p, c in path_counters.items()}
            out = kernel(*args, **kw)
            torch.cuda.synchronize()
            path = next(p for p in PATHS if path_counters[p].launches > before[p])
            want = int8_conv_nhwc_plain(*args, **kw)
            mod, name = current["mod"], current["name"]
            call = signature.bind(*args, **kw)
            call.apply_defaults()
            a = call.arguments
            err = float((out.float() - want.float()).abs().max())
            row = dict(site=name, equal=bool(torch.equal(out, want)), err=err,
                       x=tuple(a["x"].shape), n=a["ws"].shape[0], dtype=str(out.dtype)[6:],
                       path=path)
            del want
            b_ms, b_by, ops, nbytes = int8_site_bound(a, 1 if a["pair"] is not None
                                                      else mod.groups)
            row.update(bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes)
            if timed:
                row["ms"] = timer.ms(lambda: kernel(*args, **kw))
                row["plain_ms"] = timer.ms(lambda: int8_conv_nhwc_plain(*args, **kw), reps=5)
                row["cudnn_bf16_ms"] = yardstick(mod, a)
                # the other halo kernel on the same inputs, where it applies
                other = {"wgmma": "halo", "halo": "wgmma"}.get(path)
                row["other"] = other and (other, forced_ms(other, args, kw))
                log(f"[int8 kernel]   {name} x {row['x']}"
                    + (f" + pair {tuple(a['pair'][0].shape)}" if a["pair"] is not None else "")
                    + f" -> N {row['n']}, {'3x3' if a['kernel'] == (3, 3) else a['kernel']}"
                    f"{' transpose' if a['transpose'] else ''}: kernel ({path}) {row['ms']:.4f} "
                    f"ms, plain {row['plain_ms']:.4f}, bound {b_ms:.4f} ({b_by}), cuDNN bf16 "
                    f"{row['cudnn_bf16_ms']:.4f}"
                    + (f", {other} path {row['other'][1]:.4f}" if row["other"]
                       and row["other"][1] is not None else ""))
            rows.append(row)
            return out

        def enter(mod, args, name):
            current.update(mod=mod, name=name)

        handles = [m.register_forward_pre_hook(functools.partial(enter, name=name))
                   for name, m in pred.model.named_modules() if isinstance(m, quant.Int8Conv)]
        quant.int8_conv_nhwc = recorder
        try:
            pred(x)
            torch.cuda.synchronize()
        finally:
            quant.int8_conv_nhwc = kernel
            for h in handles:
                h.remove()
        bad = [r["site"] for r in rows if not r["equal"]]
        check(not bad, f"the int8 conv kernel differs from its plain version at {bad}")
        check(len(rows) == int8_sites(pred), f"{len(rows)} int8 conv calls, "
              f"{int8_sites(pred)} int8 convs")
        return rows

    def by_depth(rows, label):
        depths = {}
        for r in rows:
            d = depths.setdefault(r["site"].split(".")[0], dict(
                sites=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, cudnn_bf16_ms=0.0, ops=0,
                bytes=0, by=set()))
            d["sites"] += 1
            for k in ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms", "ops", "bytes"):
                d[k] += r[k]
            d["by"].add(r["bound_by"])
        for r in rows:  # the wide sites: the halo kernel they left, on the same inputs
            if r.get("path") == "wgmma" and r.get("other") and r["other"][1] is not None:
                d = depths[r["site"].split(".")[0]]
                d["wide_ms"] = d.get("wide_ms", 0.0) + r["ms"]
                d["old_halo_ms"] = d.get("old_halo_ms", 0.0) + r["other"][1]
        for name, d in sorted(depths.items()):
            d["by"] = "/".join(sorted(d["by"]))
            log(f"[int8 kernel] {label} {name} ({d['sites']} convs): kernel {d['ms']:.4f} ms, "
                f"plain {d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms ({d['by']}; "
                f"{d['ops'] / 1e9:.1f} GOP, {d['bytes'] / 1e6:.1f} MB) = "
                f"{d['bound_ms'] / d['ms']:.1%} of bound; cuDNN bf16 conv of the same shapes "
                f"{d['cudnn_bf16_ms']:.4f} ms (a yardstick: no quantisation)"
                + (f"; its wide sites {d['wide_ms']:.4f} ms on the wide halo path, "
                   f"{d['old_halo_ms']:.4f} ms on the halo path" if "wide_ms" in d else ""))
        total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms",
                                                       "cudnn_bf16_ms", "ops", "bytes")}
        total["paths"] = {p: sum(r["path"] == p for r in rows) for p in PATHS}
        ops_ms = total["ops"] / INT8_OPS_PER_S * 1e3
        total["bound_by"] = "operations" if ops_ms >= total["bytes"] / HBM_BYTES_PER_S * 1e3 \
            else "bytes"
        total["max_abs_err"] = max(r["err"] for r in rows)
        log(f"[int8 kernel] {label}, all {len(rows)} convs: kernel {total['ms']:.4f} ms, plain "
            f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
            f"({total['bound_ms'] / total['ms']:.1%}), cuDNN bf16 {total['cudnn_bf16_ms']:.4f} ms "
            f"on {smi}; paths {total['paths']}")
        return total, depths

    # 15.1 scope decoder and scope all at B = SERVE_B: every site bit for bit,
    # the decoder's timed per depth
    results = {}
    for scope in ("decoder", "all"):
        pred = Predictor(weights, int8_decoder=True, calibration_batches=[calib],
                         int8_scope=scope, graphed=False)
        rows = run_sites(pred, images, timed=scope == "decoder")
        log(f"[int8 kernel] scope {scope}, B={SERVE_B}: {len(rows)} int8 conv calls, each "
            f"equal to the plain version on its inputs bit for bit ("
            + ", ".join(sorted({r['dtype'] for r in rows})) + ")")
        if scope == "decoder":
            results["serve"] = by_depth(rows, f"B={SERVE_B} bf16")
        del pred
    # 15.2 the whole int8 forward, graphed (warm-up, capture, replay), against
    # a twin whose sites run the plain version
    for scope in ("decoder", "all"):
        pred = Predictor(weights, int8_decoder=True, calibration_batches=[calib],
                         int8_scope=scope)
        got = [pred(images) for _ in range(3)]
        quant.int8_conv_nhwc = int8_conv_nhwc_plain
        try:
            twin = Predictor(weights, int8_decoder=True, calibration_batches=[calib],
                             int8_scope=scope, graphed=False)
            want = twin(images)
        finally:
            quant.int8_conv_nhwc = kernel
        check(all(np.array_equal(g, want) for g in got),
              f"scope {scope}: the int8 forward differs from the plain route's")
        log(f"[int8 kernel] scope {scope}: the graphed int8 Predictor's outputs (warm-up, capture, "
            f"replay, B={SERVE_B}) equal a twin's whose int8 convs run the plain version "
            f"(quantise, im2col, torch._int_mm, float32 dequantisation) bit for bit")
        del pred, twin, got, want
    release(torch)
    # 15.3 the bench's configuration at B = BENCH_B: its decoder's sites
    xs = bench.phantom_batch(BENCH_B, 304)
    pred = Predictor(weights, int8_decoder=True, graphed=False, dense_groups="decoder",
                     calibration_batches=[xs[:bench.CALIBRATION_IMAGES]])
    rows = run_sites(pred, xs, timed=True)
    results["bench"] = by_depth(rows, f"B={BENCH_B} bf16 (the bench's Predictor)")
    del rows
    check(results["bench"][0]["paths"]["wgmma"] >= 6,
          f"B={BENCH_B}: {results['bench'][0]['paths']} sites per path, not the six of "
          "depths 2-4 on the wide halo path")
    del pred
    release(torch)
    results["crossover"] = int8_crossover(torch, smi, timer)
    return results


def bn_act_sites(torch, hw=304):
    """[(C, H, W, residual)] of every `ops.norm.bn_act` call of one folded
    bf16 eval forward of the served ResnestUNet (fused decoder) at hw²,
    B = 1, on the card, in order; residual is 'none', 'raw' (an identity
    shortcut) or 'bn' (a downsample BN in the same pass). Read by patching
    the name the model's modules call."""
    from octave_tpu_torch.models import resnest
    from octave_tpu_torch.models.segmentor import ResnestUNet
    from octave_tpu_torch.ops.norm import folded_inference

    sites, real = [], resnest.bn_act

    def record(bn, x, residual=None, res_bn=None, relu_inplace=False):
        kind = "none" if residual is None else "raw" if res_bn is None else "bn"
        sites.append((x.shape[1], x.shape[2], x.shape[3], kind))
        return real(bn, x, residual, res_bn, relu_inplace)

    model = folded_inference(ResnestUNet(2, use_fused_decoder=True)).to(
        "cuda", torch.bfloat16).to(memory_format=torch.channels_last).eval()
    resnest.bn_act = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, hw, hw, 3, device="cuda", dtype=torch.bfloat16))
    finally:
        resnest.bn_act = real
    return sites


def bn_act_inputs(torch, site, batch, dtype, gen):
    """Random arguments of `fused_bn_act` at one site: x and the residual
    N(0, 4) channels-last, affines drawn as folded batch norms hold them
    (scale 0.5-2, bias -1-1)."""
    c, h, w, kind = site

    def act():
        x = torch.randn(batch, c, h, w, generator=gen, device="cuda") * 2
        return x.to(dtype, memory_format=torch.channels_last)

    def affine():
        scale = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
        return scale.to(dtype), (torch.rand(c, generator=gen, device="cuda") * 2 - 1).to(dtype)

    args = (act(), *affine())
    if kind != "none":
        args += (act(),) + (affine() if kind == "bn" else ())
    return args


def bn_act_bytes(site, batch, itemsize):
    """The least bytes of one site: x (and the residual) read once, y
    written once, the affines read once."""
    c, h, w, kind = site
    acts = 2 + (kind != "none")
    return itemsize * (acts * batch * c * h * w + c * (2 + 2 * (kind == "bn")))


def phase_bn_act(torch, smi, batches=(SERVE_B, BENCH_B)):
    """Phase 16: the fused batch norm, residual join and ReLU kernel
    (`ops/kernels/bn_act.py`) at every site of the served model's forward
    (`bn_act_sites`, 304²), at B = SERVE_B and BENCH_B in bf16 on random
    inputs: each distinct site held to the plain chain bit for bit, the
    kernel's and the plain chain's median times (L2 flushed) beside the
    byte bound at 3.35 TB/s, summed over the forward's sites. Returns the
    JSON line's bn_act row."""
    from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act, fused_bn_act_plain

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(16)
    sites = bn_act_sites(torch)
    counts = {s: sites.count(s) for s in dict.fromkeys(sites)}
    log(f"[bn_act] {len(sites)} sites in one forward, {len(counts)} distinct: "
        + ", ".join(f"{c}x{h}x{w} {kind} x{n}" for (c, h, w, kind), n in counts.items()))
    totals = {}
    for b in batches:
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, gbytes=0.0)
        for site, n in counts.items():
            args = bn_act_inputs(torch, site, b, torch.bfloat16, gen)
            got, want = fused_bn_act(*args), fused_bn_act_plain(*args)
            check(torch.equal(got, want), f"B={b} site {site}: the kernel differs from the "
                  f"plain chain by {float((got.float() - want.float()).abs().max())}")
            del got, want
            ms = timer.ms(lambda: fused_bn_act(*args))
            plain = timer.ms(lambda: fused_bn_act_plain(*args))
            nbytes = bn_act_bytes(site, b, 2)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"[bn_act] B={b} {site} x{n}: kernel {ms:.4f} ms ({100 * bound / ms:.1f}% of "
                f"{bound:.4f} ms), plain {plain:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                         ("gbytes", nbytes / 1e9)):
                tot[k] += n * v
            del args
            torch.cuda.empty_cache()
        totals[b] = tot
        log(f"[bn_act] B={b} bf16, the forward's {len(sites)} sites: kernel {tot['ms']:.4f} ms, "
            f"plain chain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['gbytes']:.2f} GB): {100 * tot['bound_ms'] / tot['ms']:.1f}% of the bound, "
            f"{tot['plain_ms'] / tot['ms']:.2f}x the plain chain, on {smi}")
    return {"sites": len(sites), "by_batch": totals}


# (name, C_in of each source, N, H = W) of the decoder's 3x3 sites with
# N >= 128 (the dense-lowered grouped convs are dense here too)
WIDE_SITES = [("decoder_1.conv.3.conv", (64,), 128, 152),
              ("decoder_2.conv.0", (256, 256), 256, 76),
              ("decoder_2.conv.3.conv", (256,), 512, 76),
              ("decoder_3.conv.0", (512, 512), 512, 38),
              ("decoder_3.conv.3.conv", (512,), 1024, 38),
              ("decoder_4.conv.0", (1024, 1024), 1024, 19),
              ("decoder_4.conv.3.conv", (1024,), 2048, 19)]


def int8_crossover(torch, smi, timer, batches=(1, 8, 32, 256)):
    """The table that sets the int8 conv's crossover between its halo and
    wide halo paths: at each batch, each wide site's time on either path
    (forced; random bf16 activations and int8 weights) beside the path the
    shape selects and the tiles of 128 grid positions x BN it makes."""
    from octave_tpu_torch.ops.kernels.int8_conv import forced_path, int8_conv_nhwc, path_counters

    rows = []
    for b in batches:
        for name, cins, n, hw in WIDE_SITES:
            def operand(c):  # the scale as calibration sets one: absmax / 127
                x = torch.randn(b, hw, hw, c, device="cuda").to(torch.bfloat16)
                return (x, torch.randint(-127, 128, (n, 9 * c), dtype=torch.int8, device="cuda"),
                        torch.full((n,), 1e-3, device="cuda"),
                        (x.float().abs().max() / 127).reshape(()))
            ops = [operand(c) for c in cins]
            kw = dict(kernel=(3, 3), padding=(1, 1),
                      pair=ops[1] if len(ops) == 2 else None)
            before = {p: c.launches for p, c in path_counters.items()}
            int8_conv_nhwc(*ops[0], **kw)
            torch.cuda.synchronize()
            auto = next(p for p, c in path_counters.items() if c.launches > before[p])
            ms = {}
            for path in ("halo", "wgmma"):
                with forced_path(path):
                    ms[path] = timer.ms(lambda: int8_conv_nhwc(*ops[0], **kw))
            bn = 256 if n % 256 == 0 else 128
            tiles = -(-b * (hw + 1) ** 2 // 128) * -(-n // bn)
            rows.append(dict(batch=b, site=name, auto=auto, tiles=tiles, **ms))
            log(f"[int8 crossover] B={b} {name}: halo {ms['halo']:.4f} ms, wide halo "
                f"{ms['wgmma']:.4f} ms ({ms['halo'] / ms['wgmma']:.2f}x), {tiles} tiles, "
                f"selected {auto}")
            del ops
        torch.cuda.empty_cache()
    wrong = [(r["batch"], r["site"]) for r in rows
             if r["auto"] != min(("halo", "wgmma"), key=lambda p: r[p])
             and max(r["halo"], r["wgmma"]) > 1.05 * min(r["halo"], r["wgmma"])]
    log(f"[int8 crossover] on {smi}: sites where the selection takes the slower path by more "
        f"than 5%: {wrong or 'none'}")
    return rows


def release(torch):
    """Collect Python's garbage and empty the caching allocator between
    phases."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def nudge_(torch, module, seed=0):
    """Multiply each floating parameter element of `module` by 1 + 2^-23 or
    1 - 2^-23 (signs from `seed`): a float32 rounding step, the witness of
    how far float32 noise alone moves a run."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                up = torch.rand(p.shape, generator=gen) < 0.5
                p.mul_(torch.where(up, 1 + 2.0 ** -23, 1 - 2.0 ** -23).to(p))


def update_rel_l2(torch, got, want, got0, want0):
    """Relative L2 of the update got - got0 from the update want - want0
    over the floating tensors of segmentor state dicts (BN running stats
    left out)."""
    num = den = 0.0
    for k, v in want.items():
        if v.is_floating_point() and not k.endswith(("running_mean", "running_var")):
            u = (v - want0[k]).double()
            num += float((((got[k] - got0[k]).double() - u) ** 2).sum())
            den += float((u ** 2).sum())
    return (num / den) ** 0.5


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_l2_pairs(torch, pairs):
    """Relative L2 distance of the first tensors from the second, over all
    pairs as one vector."""
    num = sum(float(((a.double().cpu() - b.double().cpu()) ** 2).sum()) for a, b in pairs)
    den = sum(float((b.double().cpu() ** 2).sum()) for _, b in pairs)
    return (num / den) ** 0.5


if __name__ == "__main__":
    sys.exit(main())
