#!/usr/bin/env python3
"""The critic's output layer as a convolution and as a GEMM, on one NVIDIA
GPU. Run from the repository root on a machine with CUDA:

    python3 scripts/critic_out_conv.py

The critic's output conv has a kernel as large as the map it receives (one
logit per sample): 9x9 over 1,024 channels for the depth-4 critic at 304²,
76x76 over 128 channels for the depth-1 critic of the gated dual decoders.
For B = 8 under bf16 autocast this times, on the card, the forward and
forward + backward (input and weight gradients) of that layer as
`F.conv2d` (cuDNN) and as `F.linear` over the flattened NHWC map (what
`models/discriminator.py::DiscriminatorBlock` runs), checks that both give
the same logits and gradients, and times the whole critic's forward +
backward. Medians of 20 runs after 3 warm-up runs, CUDA events.
"""
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, HW = 8, 304


def median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("critic_out_conv: needs a CUDA device", file=sys.stderr)
        return 1
    from octave_tpu_torch.models.discriminator import DiscriminatorBlock

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for depth in (4, 1):
        critic = DiscriminatorBlock((HW, HW), depth=depth).cuda()
        critic = critic.to(memory_format=torch.channels_last).train()
        conv = critic.out[0]
        c, (kh, kw) = conv.in_channels, conv.kernel_size
        x = torch.randn(B, c, kh, kw, generator=gen, device="cuda").to(
            memory_format=torch.channels_last).requires_grad_()

        def as_conv():
            return F.conv2d(x, conv.weight, conv.bias).reshape(B, -1)

        def as_gemm():
            return F.linear(x.permute(0, 2, 3, 1).reshape(B, -1),
                            conv.weight.permute(0, 2, 3, 1).reshape(1, -1), conv.bias)

        results = {}
        for name, fn in (("conv", as_conv), ("gemm", as_gemm)):
            def fwd():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    return fn()

            def fwd_bwd():
                return torch.autograd.grad(fwd().float().sum(), (x, conv.weight))

            out, grads = fwd().float().detach(), fwd_bwd()
            results[name] = (out, grads, median_ms(fwd), median_ms(fwd_bwd))
        (o_c, g_c, f_c, fb_c), (o_g, g_g, f_g, fb_g) = results["conv"], results["gemm"]
        err = max(float((o_c - o_g).abs().max() / o_c.abs().max()),
                  *(float((a.float() - b.float()).abs().max() / a.float().abs().max())
                    for a, b in zip(g_c, g_g)))
        pyr = [torch.rand(B, HW // 2**i, HW // 2**i, 2, generator=gen, device="cuda")
               .requires_grad_() for i in range(depth + 1)]

        def critic_fwd_bwd():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y = critic(pyr, gen)
            y.float().sum().backward()

        print(f"depth {depth}: output conv {c} x {kh} x {kw}, B={B}, bf16 autocast: forward "
              f"conv {f_c:.4f} ms, gemm {f_g:.4f} ms; forward + backward conv {fb_c:.4f} ms, "
              f"gemm {fb_g:.4f} ms; largest difference of logits and gradients, relative to "
              f"each one's largest entry, {err:.2e}; whole critic forward + backward (gemm) "
              f"{median_ms(critic_fwd_bwd, reps=10):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
