"""Same-padding calculators and the uniform scalar helper.

The port of `octave_tpu/utils/padding.py`, the reference's utils.py:8-22:
unused by the main path but part of its public surface.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def get_same_padding_conv(input_size: int, kernel_size: int, stride: int) -> int:
    """Padding so that n_out == n_in for a square conv (utils.py:8-13)."""
    padding_size = ((stride * (input_size - 1)) - input_size + kernel_size) / 2
    return math.ceil(padding_size)


def get_same_padding_transpose(input_size: int, kernel_size: int, stride: int) -> int:
    """Transpose-conv same-padding (utils.py:16-18; the reference's formula,
    its // 2 floor included)."""
    return (stride - (input_size * (1 - stride)) + kernel_size) // 2


def rand_uniform(generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One U(0, 1) scalar drawn from `generator` (utils.py:20-22: the
    reference's torch.FloatTensor(1).uniform_(0, 1)), on the generator's
    device."""
    device = generator.device if generator is not None else None
    return torch.rand((), generator=generator, dtype=dtype, device=device)
