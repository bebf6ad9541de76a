"""The plain float32 adversarial training step of OCTAve.

One step, on a batch of angiograms with scribbles and dense masks:

    pyramid, logits = segmentor(image)              (batch-statistics BN)
    L_seg = WPCE(softmax(logits), scribbles) + ILD(pyramid) + LSGAN_G(critic(pyramid))
    Adam step of the segmentor
    L_D = LSGAN_D(critic(mask pyramid), critic(pyramid detached))
    Adam step of the critic

WPCE weighs each class by the scribble pixels of all classes over its own
(the background channel counted); ILD is the KL divergence of the finest
attention map from the weighted mean log of the coarser ones, each
nearest-upscaled; the LS-GAN targets are +1 and -1. The generator phase runs
the critic's power iteration without keeping it; the critic phase keeps it,
fake then real. The critic's noise is drawn from a generator seeded as the
program seeds its own, in the same order and shapes. Adam is torch's
(beta 0.9, 0.999, eps 1e-8) under a polynomial learning-rate decay.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import NUM_CLASSES, Net, Params, critic

EPS = 1e-12


def prepare(images: np.ndarray, scribbles: np.ndarray, masks: np.ndarray, depth: int,
            device) -> Dict[str, object]:
    """uint8 (b, h, w) host arrays -> the step's NHWC float32 inputs."""
    img = torch.from_numpy(images).to(device).float().div(255.0)
    img = img.unsqueeze(-1).expand(*img.shape, 3).contiguous()
    v = torch.from_numpy(scribbles).to(device).long()
    scrib = F.one_hot((v - 1).clamp(min=0), NUM_CLASSES).float() * (v > 0).unsqueeze(-1)
    dense = F.one_hot(torch.from_numpy(masks).to(device).long(), NUM_CLASSES).float()
    pyramid = [dense[:, ::2 ** i, ::2 ** i] for i in range(depth + 1)]
    return {"image": img, "scribble_onehot": scrib, "mask_pyramid": pyramid}


def wpce(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    counts = target.sum(dim=(0, 1, 2))
    weights = counts.sum() / (counts + EPS)
    return (-(weights * target * torch.log(probs * target + EPS)).sum(-1)).mean()


def ild(pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
    basis = pyramid[0]
    b, h, w, _ = basis.shape
    cross = 0.0
    for att in pyramid[1:]:
        f = h // att.shape[1]
        up = att.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        cross = cross + torch.sum(basis * torch.log(up + EPS))
    ent = torch.sum(basis * torch.log(basis + EPS))
    return (ent - cross / (len(pyramid) - 1)) / (b * h * w)


def lr_at(init: float, end: float, decay_steps: int, power: float, count: int) -> float:
    frac = 1.0 - min(count, decay_steps) / decay_steps
    return (init - end) * frac ** power + end


class Adam:
    """torch.optim.Adam's update for a dict of leaves, with its moments."""

    def __init__(self, params: Params, lr_args: tuple, betas=(0.9, 0.999), eps=1e-8):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.lr_args, self.betas, self.eps, self.t = lr_args, betas, eps, 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        lr = lr_at(*self.lr_args, self.t)
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-lr / c1)


class Trainer:
    """The reference's state: segmentor and critic leaves, the critic's
    power-iteration vectors, both optimizers and the noise generator."""

    def __init__(self, seg: Params, crit: Params, depth: int, optim: Dict, noise_seed: int,
                 device, real_noise_dtype: torch.dtype):
        self.seg = {k: v.detach().clone() for k, v in seg.items()}
        self.crit = {k: v.detach().clone() for k, v in crit.items()
                     if not k.endswith(("weight_u", "weight_v"))}
        self.buffers = {k: v.detach().clone() for k, v in crit.items()
                        if k.endswith(("weight_u", "weight_v"))}
        self.trainable = [k for k, v in self.seg.items() if v.is_floating_point()
                          and not k.endswith(("running_mean", "running_var"))]
        self.depth = depth
        end, steps, power = optim["end_lr"], optim["decay_steps"], optim["power"]
        self.seg_opt = Adam({k: self.seg[k] for k in self.trainable},
                            (optim["seg_lr"], end, steps, power))
        self.crit_opt = Adam(self.crit, (optim["disc_lr"], end, steps, power))
        self.gen = torch.Generator(device=device).manual_seed(noise_seed)
        self.real_noise_dtype = real_noise_dtype
        self.fault: Optional[str] = None  # a planted fault of the check's controls

    def step(self, batch: Dict[str, object]) -> Dict[str, float]:
        seg = {k: (v.requires_grad_(True) if k in self.trainable else v)
               for k, v in self.seg.items()}
        pyramid, logits = Net(seg, train=True).segmentor(batch["image"])
        judged = pyramid[:self.depth + 1]
        l_sup = wpce(torch.softmax(logits, dim=-1), batch["scribble_onehot"])
        l_ild = ild(pyramid)
        frozen = {k: v.detach() for k, v in self.crit.items()}
        y = critic(frozen, self.buffers, judged, self.depth, self.gen, False, torch.float32)
        l_adv = 0.5 * torch.mean(torch.square(y - 1.0))
        total = l_sup + (0.0 if self.fault == "no_ild" else l_ild) + (
            0.0 if self.fault == "no_adv" else l_adv)
        grads = torch.autograd.grad(total, [seg[k] for k in self.trainable])
        for k in self.trainable:
            seg[k].requires_grad_(False)
        self.seg_opt.step(self.seg, dict(zip(self.trainable, grads)))

        crit = {k: v.requires_grad_(True) for k, v in self.crit.items()}
        fake = [a.detach() for a in judged]
        real = batch["mask_pyramid"][:self.depth + 1]
        y_fake = critic(crit, self.buffers, fake, self.depth, self.gen, True, torch.float32)
        y_real = critic(crit, self.buffers, real, self.depth, self.gen, True,
                        self.real_noise_dtype)
        l_d = 0.5 * torch.mean(torch.square(y_real - 1.0)) + 0.5 * torch.mean(
            torch.square(y_fake + 1.0))
        grads = torch.autograd.grad(l_d, list(crit.values()))
        for v in crit.values():
            v.requires_grad_(False)
        if self.fault != "frozen_critic":
            self.crit_opt.step(self.crit, dict(zip(crit, grads)))
        return {"loss_sup": float(l_sup.detach()), "loss_ild": float(l_ild.detach()),
                "loss_adv": float(l_adv.detach()),
                "loss_seg_total": float(total.detach()), "loss_disc": float(l_d.detach())}

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of every leaf: after one step, 0.1 x the
        gradient the update took."""
        return {**{"seg/" + k: v for k, v in self.seg_opt.m.items()},
                **{"critic/" + k: v for k, v in self.crit_opt.m.items()}}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {**{"seg/" + k: self.seg[k] for k in self.trainable},
                **{"critic/" + k: v for k, v in self.crit.items()}}

