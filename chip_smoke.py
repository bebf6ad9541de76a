#!/usr/bin/env python3
"""GPU smoke test of octave_tpu_torch: builds its kernels and drives its
serving path on one NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. build   - compile both Triton kernels from this checkout's sources into
               build/triton (emptied first) and time the build;
  2. kernels - each kernel against its plain PyTorch version at the five
               decoder shapes of the 304² forward, in float32 with B = 8 and
               in bfloat16 with B = 8 and B = 32 (the serving batch), with
               median times (L2 flushed before every launch) and the byte
               bound; the kernels JSON line carries the bf16 B = 32 figures;
  3. golden  - the port's ResnestUNet in float32 (TF32 off) at 304² on the
               reference fill of tests/golden/unet304.npz, through the fused
               epilogue and through the AAG kernel, against the reference's
               stored outputs (1e-3, as tests/test_golden.py);
  4. serve   - Predictor on the committed trained weights (bf16, folded BN,
               uint8 input, 304², B = 32): each serving path run once with
               its own launch counts (__call__, the main path; predict_many;
               mask_u8; the unfused AAG configuration), output checks,
               mask agreement with the plain float32 path,
               images/s of __call__ and predict_many (k = 4), and a
               torch.profiler breakdown of one __call__ by kernel group.
Exits non-zero, before printing any result, without CUDA or outside a
checkout of the repository; any failed check
raises. The last three lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
DEPTHS = [(304, 304, 32), (152, 152, 64), (76, 76, 256), (38, 38, 512), (19, 19, 1024)]
SERVE_B = 32
# (dtype, batch) of the kernel comparisons; the JSON line reports the last
CASES = [("float32", 8), ("bfloat16", 8), ("bfloat16", SERVE_B)]
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


def kernel_group(name):
    """Coarse layer of a device kernel, by its name, for the serving profile."""
    if name in ("aag_fwd_kernel", "decoder_epilogue_kernel"):
        return "triton kernels"
    if name.startswith("Memcpy"):
        return "host-device copies"
    if any(s in name for s in ("xmma", "cutlass", "conv", "gemm", "tensorTransform",
                                "nhwcSlice", "Nhwc", "Nchw")):
        return "cuDNN convolutions"
    return "elementwise, pooling, cat, reductions"


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
    from octave_tpu_torch.ops.kernels import BUILD_DIR, kernel_tolerance, triton_build_dir
    from octave_tpu_torch.ops.kernels.aag import fused_aag, fused_aag_plain
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
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(0)

    # -- 1. build ---------------------------------------------------------
    shutil.rmtree(BUILD_DIR, ignore_errors=True)
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

    # -- 2. kernels against their plain versions ---------------------------
    timer = Timer(torch)
    totals = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes=0, by=set())
              for n in kernels}
    for name, kern in kernels.items():
        for dname, bsz in CASES:
            dt = dtypes[dname]
            for hwc in DEPTHS:
                shape = (bsz, *hwc)
                args = kernel_inputs(torch, name, shape, dt, gen)
                out, yhat = kern["fn"](*args)
                torch.cuda.synchronize()
                ref_out, ref_yhat = kern["plain"](*args)
                errs = []
                for got, want, (atol, rtol) in zip((out, yhat), (ref_out, ref_yhat),
                                                   kernel_tolerance(name, dt, shape[3])):
                    d = (got.float() - want.float()).abs()
                    lim = atol + rtol * want.float().abs()
                    check(bool(torch.isfinite(got).all()), f"{name} {dname} {shape}: non-finite")
                    check(bool((d <= lim).all()), f"{name} {dname} {shape}: max err "
                          f"{d.max().item():.3g} over atol {atol} rtol {rtol}")
                    errs.append(d.max().item())
                ms = timer.ms(lambda: kern["fn"](*args))
                plain_ms = timer.ms(lambda: kern["plain"](*args), reps=5)
                b_ms, b_by, nbytes = bound(name, shape, dt.itemsize)
                log(f"[kernels] {name} {dname} {shape}: max|err| out {errs[0]:.3g} "
                    f"y_hat {errs[1]:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB, "
                    f"{nbytes / ms / 1e6:.0f} GB/s achieved)")
                if (dname, bsz) == CASES[-1]:  # serving dtype and batch: the JSON line
                    t = totals[name]
                    t["ms"] += ms
                    t["plain_ms"] += plain_ms
                    t["bound_ms"] += b_ms
                    t["bytes"] += nbytes
                    t["by"].add(b_by)
                    t["err"] = max(t["err"], *errs)
                del args, out, yhat, ref_out, ref_yhat
    for name, t in totals.items():
        log(f"[kernels] {name} bf16, five depths, B={SERVE_B}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms']:.1%} of bound)")

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
        fused_aag.launches = fused_decoder_epilogue.launches = 0
        result = fn()
        torch.cuda.synchronize()
        got = {"aag": fused_aag.launches, "decoder_epilogue": fused_decoder_epilogue.launches}
        log(f"[serve] {label}: launches {got} (expected {want})")
        check(got == want, f"{label}: launch counts {got}, expected {want}")
        return result, got

    # __call__ is the main path; each kernel's JSON count is that of the
    # serving path it belongs to (the AAG kernel's: use_fused_decoder=False)
    probs, main_launches = counted("__call__ (main path)", lambda: serve(images),
                                   {"aag": 0, "decoder_epilogue": 5})
    many, _ = counted("predict_many k=4", lambda: serve.predict_many(stack),
                      {"aag": 0, "decoder_epilogue": 20})
    mask, _ = counted("mask_u8", lambda: serve_mask(images), {"aag": 0, "decoder_epilogue": 5})
    probs_aag, aag_launches = counted("use_fused_decoder=False", lambda: serve_aag(images),
                                      {"aag": 5, "decoder_epilogue": 0})
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
    t0 = time.time()
    ref_mask = plain(images[:n_ref])
    agree_ref = float((ref_mask == mask[:n_ref]).mean())
    log(f"[serve] bf16 checks: finite, |sum-1| max {sum_err:.3g}, vessel share "
        f"{(mask > 0).mean():.4f}; agreement mask_u8/prob_f32 {agree_mask:.6f}, "
        f"argmax predict_many/call {agree_many:.6f}, "
        f"aag/fused {agree_aag:.6f}; mask_u8 vs plain fp32 path on CPU ({n_ref} images, "
        f"{time.time() - t0:.1f} s): {agree_ref:.6f} (floor {MASK_AGREEMENT_FLOOR})")
    check(min(agree_mask, agree_many, agree_aag) >= PATH_AGREEMENT_FLOOR,
          "bf16 serving paths disagree")
    check(agree_ref >= MASK_AGREEMENT_FLOOR, f"mask agreement {agree_ref} < floor")

    def wall(fn, reps):
        fn()
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    t_call = wall(lambda: serve(images), 10)
    t_many = wall(lambda: serve.predict_many(stack), 5)
    log(f"[serve] 304² bf16 trained weights, B={SERVE_B}, uint8 in, prob_f32 out, on {smi}: "
        f"__call__ {SERVE_B / t_call:.1f} img/s ({t_call * 1e3:.1f} ms/batch); predict_many k=4 "
        f"{4 * SERVE_B / t_many:.1f} img/s ({t_many * 1e3:.1f} ms/call)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(images)
        torch.cuda.synchronize()
        t_prof = (time.perf_counter() - t0) * 1e3
    groups = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.name.startswith("Activity"):
            g = kernel_group(ev.name)
            groups[g] = groups.get(g, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    check(busy > 0, "the profiler saw no device time")
    log(f"[serve] profile of one __call__ (B={SERVE_B}): wall {t_prof:.1f} ms, device busy "
        f"{busy:.1f} ms, idle {1 - busy / t_prof:.1%}; "
        + ", ".join(f"{g} {v:.2f} ms" for g, v in sorted(groups.items(), key=lambda x: -x[1])))

    line = {"kernels": [
        {"name": name, "route": "triton", "source": kern["source"],
         "replaces": kern["replaces"], "launches": launches[name],
         "max_abs_err": totals[name]["err"], "ms": totals[name]["ms"],
         "plain_ms": totals[name]["plain_ms"], "bound_ms": totals[name]["bound_ms"],
         "bound_by": "bytes" if totals[name]["by"] == {"bytes"} else "operations",
         "library_ms": None}
        for name, kern in kernels.items()]}
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
