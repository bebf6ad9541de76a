"""LS-GAN losses with the reference's +1/-1 targets.

The port of `octave_tpu/losses/gan.py` (:12-22): least-squares targets of
+1 (real) and -1 (fake), not the textbook 1/0.
"""
from __future__ import annotations

import torch


def ls_discriminator_loss(y_real: torch.Tensor, y_fake: torch.Tensor) -> torch.Tensor:
    """D = 0.5*mean((y_real - 1)^2) + 0.5*mean((y_fake + 1)^2)."""
    return 0.5 * torch.mean(torch.square(y_real - 1.0)) + 0.5 * torch.mean(
        torch.square(y_fake + 1.0))


def ls_generator_loss(y_fake: torch.Tensor) -> torch.Tensor:
    """G = 0.5*mean((y_fake - 1)^2)."""
    return 0.5 * torch.mean(torch.square(y_fake - 1.0))


class LSDiscriminatorialLoss:
    """The reference's class (its name and spelling kept)."""

    def __call__(self, y_real, y_fake):
        return ls_discriminator_loss(y_real, y_fake)


class LSGeneratorLoss:
    def __call__(self, y_fake):
        return ls_generator_loss(y_fake)
