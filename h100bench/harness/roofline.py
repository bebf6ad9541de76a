"""Peaks of one NVIDIA H100 SXM and the least time of the port's kernels,
from shapes: the yardstick of the roofline and MFU readers.

The byte bound of the decoder epilogue and the int8 sites' bounds are the
arithmetic of `chip_smoke.py::bound` and `::int8_site_bound`, frozen here:
each input read once, each output written once, operations at the card's
rate for their type; the larger of the two times bounds a launch.
"""
from __future__ import annotations

from typing import Dict, Iterable

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES = 3.35e12


def epilogue_bound_s(depths: Iterable[Dict], batch: int, classes: int,
                     itemsize: int = 2) -> float:
    """Least seconds of one forward's decoder-epilogue launches, one per
    gated depth of the configuration's `per_image.epilogue_depths` (its
    side `hw` and `channels`): the bytes of z, the shortcut and the output
    activations, the per-sample radix logits, the per-channel affine and
    the gate's weights, against their float32 operations."""
    total = 0.0
    for d in depths:
        c, n = d["channels"], batch * d["hw"] ** 2
        nbytes = (n * 3 * c * itemsize + batch * 2 * c * 4 + (2 * c + c * classes + classes) * 4
                  + n * (c + classes) * itemsize)
        ops = n * (8 + 2 * classes) * c
        total += max(nbytes / HBM_BYTES, ops / FP32_FLOPS)
    return total


def int8_site_bound_s(site: Dict, batch: int) -> float:
    """Least seconds of one int8 conv launch (a site of the configuration's
    `per_image.int8_sites`): its multiply-adds (a grouped conv's, not its
    block-diagonal zeros) at the int8 rate, or its bytes: each bf16 input
    source read once, the int8 weight, the scales, the float32 bias, the
    bf16 output written once."""
    k_true = [site["k"] ** 2 * c // site["groups"] for c in site["sources"]]
    cout, n_src = site["cout"], len(site["sources"])
    ops = 2 * batch * site["hw_out"] ** 2 * cout * sum(k_true)
    nbytes = sum(batch * site["hw"] ** 2 * c * 2 for c in site["sources"])
    nbytes += cout * sum(k_true) + 4 * cout * n_src + 4 * n_src
    nbytes += 4 * cout if site["bias"] else 0
    nbytes += batch * site["hw_out"] ** 2 * cout * 2
    return max(ops / INT8_OPS, nbytes / HBM_BYTES)


def int8_forward_bound_s(sites: Iterable[Dict], batch: int) -> float:
    return sum(int8_site_bound_s(s, batch) for s in sites)


def is_int8_conv(name: str) -> bool:
    """The port's int8 conv kernel (both of its paths), by kernel name."""
    n = name.lower()
    return "int8_conv_kernel" in n or "int8_conv_halo_kernel" in n


def is_epilogue(name: str) -> bool:
    return "decoder_epilogue_kernel" in name


def is_copy(name: str) -> bool:
    """A host-device copy (the profiler names them Memcpy HtoD / DtoH)."""
    return name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name)
