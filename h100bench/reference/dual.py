"""The plain float32 gated dual decoders (`parallel_head_gate`) and their
adversarial step with two critics.

The model is the ROSE-style thick/thin dual head (Ma et al., ROSE, IEEE TMI
2021) on the OCTAve segmentor (Chinkamol et al., IEEE TBME 2022): the
ResNeSt-50 encoder and gated U-Net decoder of `reference.model.Net`, and a
second, shallow decoder grown from the encoder's layer-1 output x_1:

    c = up("upsampling_1_c", x_1)                   256 -> 64, to x_0_0's size
    c = gate("aag_1_c", decoder("decoder_1_c", [x_0_0, c]))      128 -> 64
    c = gate("aag_0_c", decoder("decoder_0_c", up("upsampling_0_c", c)))  64 -> 32
    logits_c = fc_c(c)                                           32 -> classes

built from the blocks of `reference.model` under the program's state-dict
names (`<module>_c.*` beside the main decoder's `<module>.*`, the same widths
at depths 1 and 0). With gating level 4 the main pyramid has 5 levels and
the `_c` pyramid 2, both finest first.

One step, on a batch of angiograms with scribbles and dense masks:

    L_seg = sum over heads WPCE(softmax(logits_h), scribbles)
            + ILD(pyramid) + ILD(pyramid_c)
            + sum over critics LSGAN_G(critic_k(pyramid_k))          k = main, c
    Adam step of the segmentor
    L_D = sum over critics LSGAN_D(critic_k(mask pyramid), critic_k(pyramid_k detached))
    one Adam step over both critics' leaves

The main critic judges pyramid levels 0..4 at depth 4, the "c" critic levels
0..1 at depth 1 (its depth clamped to the levels its pyramid has). Each
critic's noise is drawn from the one generator in the program's order: the
generator phase main then c, the critic phase main's fake, main's real, c's
fake, c's real; each forward draws its instance-noise map, then its label
noise. Critic leaves are named `main.<critic name>` and `c.<critic name>`.

Departures from the published description, each the program's as well: both
heads take the same scribbles (the phantoms have one target; ROSE-1's
`thick_gt` / `thin_gt` are not in the repository); the losses and the noise
are those of `reference.train` (see its docstring). The encoder taps the
`_c` branch reads are taken where `Net.segmentor` computes them, so the
encoder runs once, as in the program.

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference.model import (
    DECODER_WIDTHS,
    ENCODER_LAYERS,
    Net,
    Params,
    conv,
    critic,
    critic_spec,
    segmentor_spec,
)
from reference.train import Trainer, ild, wpce

# the `_c` branch: these modules of the main decoder again, with `_c` added
C_MODULES = ("upsampling_1", "decoder_1", "aag_1", "upsampling_0", "decoder_0", "aag_0", "fc")
CRITICS = ("main", "c")  # in the order the program runs them


def dual_segmentor_spec() -> Dict[str, tuple]:
    """{state-dict name: (kind, shape)} of the dual decoders' segmentor."""
    spec = segmentor_spec()
    for name, value in list(spec.items()):
        module, rest = name.split(".", 1)
        if module in C_MODULES:
            spec[f"{module}_c.{rest}"] = value
    return spec


def critics_spec(hw: Tuple[int, int], depths: Dict[str, int], nf: int) -> Dict[str, tuple]:
    """{`<critic>.<name>`: (kind, shape)} of both critics."""
    return {f"{c}.{k}": v for c in CRITICS for k, v in critic_spec(hw, depths[c], nf).items()}


def part(tensors: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `tensors` under `prefix.`, the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tensors.items() if k.startswith(prefix + ".")}


class DualNet(Net):
    """`Net` that keeps the encoder taps the `_c` branch reads."""

    def bn(self, name, x):
        y = super().bn(name, x)
        if name == "encoder_0_1_2.1":
            self.x_0_0 = F.relu(y)  # the stem's output, as Net.segmentor takes it
        return y

    def bottleneck(self, name, x, *args):
        y = super().bottleneck(name, x, *args)
        if name == f"encoder_1.{ENCODER_LAYERS[0] - 1}":
            self.x_1 = y
        return y

    def dual(self, image: torch.Tensor) -> Tuple[Tuple[List[torch.Tensor], ...],
                                                 Tuple[torch.Tensor, ...]]:
        """NHWC image in [0, 1] -> ((main pyramid, `_c` pyramid), (logits,
        logits_c)): pyramids finest first, NHWC."""
        pyramid, logits = self.segmentor(image)
        c = self.up("upsampling_1_c", self.x_1)
        c = self.decoder("decoder_1_c", torch.cat([self.x_0_0, c], dim=1), DECODER_WIDTHS[1][3])
        c, y_1 = self.gate("aag_1_c", c)
        c = self.decoder("decoder_0_c", self.up("upsampling_0_c", c), DECODER_WIDTHS[0][3])
        c, y_0 = self.gate("aag_0_c", c)
        logits_c = conv(self.p, "fc_c", c).permute(0, 2, 3, 1)
        return (pyramid, [y_0, y_1]), (logits, logits_c)


class DualTrainer(Trainer):
    """`reference.train.Trainer` over the dual segmentor and both critics
    (`crit` holds `main.*` and `c.*`, under one Adam). The faults the
    check's controls plant (`fault`): "no_sup_c" (the `_c` head's WPCE
    weighed by 0), "no_ild_c" (the `_c` pyramid's ILD weighed by 0),
    "frozen_critic_c" (the "c" critic never updated)."""

    def __init__(self, seg: Params, crit: Params, depths: Dict[str, int], *args):
        super().__init__(seg, crit, depths["main"], *args)
        self.depths = depths
        self.heads: Optional[torch.Tensor] = None  # the last step's (logits, logits_c)

    def _critic(self, name, params, pyramid, update, noise_dtype):
        buffers = part(self.buffers, name)
        y = critic(part(params, name), buffers, pyramid[:self.depths[name] + 1],
                   self.depths[name], self.gen, update, noise_dtype)
        self.buffers.update({f"{name}.{k}": v for k, v in buffers.items()})
        return y

    def step(self, batch: Dict[str, object]) -> Dict[str, float]:
        seg = {k: (v.requires_grad_(True) if k in self.trainable else v)
               for k, v in self.seg.items()}
        pyramids, heads = DualNet(seg, train=True).dual(batch["image"])
        self.heads = torch.stack([h.detach() for h in heads])
        judged = dict(zip(CRITICS, pyramids))
        target = batch["scribble_onehot"]
        # a dropped term is weighed by 0, leaving its leaves zero gradients
        l_sup = wpce(torch.softmax(heads[0], dim=-1), target) + (
            0.0 if self.fault == "no_sup_c" else 1.0) * wpce(torch.softmax(heads[1], dim=-1),
                                                             target)
        l_ild = ild(pyramids[0]) + (0.0 if self.fault == "no_ild_c" else 1.0) * ild(pyramids[1])
        frozen = {k: v.detach() for k, v in self.crit.items()}
        l_adv = 0.0
        for name in CRITICS:
            y = self._critic(name, frozen, judged[name], False, torch.float32)
            l_adv = l_adv + 0.5 * torch.mean(torch.square(y - 1.0))
        total = l_sup + l_ild + l_adv
        grads = torch.autograd.grad(total, [seg[k] for k in self.trainable])
        for k in self.trainable:
            seg[k].requires_grad_(False)
        self.seg_opt.step(self.seg, dict(zip(self.trainable, grads)))

        crit = {k: v.requires_grad_(True) for k, v in self.crit.items()}
        l_d = 0.0
        for name in CRITICS:
            fake = [a.detach() for a in judged[name]]
            y_fake = self._critic(name, crit, fake, True, torch.float32)
            y_real = self._critic(name, crit, batch["mask_pyramid"], True,
                                  self.real_noise_dtype)
            l_d = l_d + 0.5 * torch.mean(torch.square(y_real - 1.0)) + 0.5 * torch.mean(
                torch.square(y_fake + 1.0))
        grads = dict(zip(crit, torch.autograd.grad(l_d, list(crit.values()))))
        for v in crit.values():
            v.requires_grad_(False)
        if self.fault == "frozen_critic_c":
            grads = {k: g for k, g in grads.items() if not k.startswith("c.")}
        self.crit_opt.step(self.crit, grads)
        return {"loss_sup": float(l_sup.detach()), "loss_ild": float(l_ild.detach()),
                "loss_adv": float(l_adv.detach()),
                "loss_seg_total": float(total.detach()), "loss_disc": float(l_d.detach())}
