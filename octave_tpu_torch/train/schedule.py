"""LR schedule and the optimizer of both GAN players.

The port of `octave_tpu/train/schedule.py` (:14-57). `make_optimizer` builds
the counterpart of optax.chain([clip_by_global_norm], adam | adamw) with a
polynomial schedule: torch.optim.Adam / AdamW (fused on CUDA) under a
LambdaLR, with the clip in optax's exact form (scale by max/||g|| only when
||g|| >= max, where `clip_grad_norm_` scales by max/(||g|| + 1e-6)). optax
evaluates the schedule at the update count before the update, so the first
step uses init_lr; LambdaLR does the same.

`moment_dtype="bfloat16"` (optax's `mu_dtype`, :28-57) stores Adam's first
moment in bf16: `MomentAdam`, plain `torch._foreach_*` ops in optax's
arithmetic, since fused Adam keeps every state in its parameter's dtype.

On CUDA an update never waits for the host, so that a train step captured
in a CUDA graph replays right (`train.steps.GraphedStep`): the learning rate
is read from a device tensor loaded before each call (a LambdaLR writes a
Python float, which a capture would bake in), the gradients are static
tensors zeroed in place, fused Adam is `capturable`, and `MomentAdam` forms
its bias corrections on the device.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def polynomial_decay(init_lr: float, end_lr: float = 1e-6, decay_steps: int = 10_000,
                     power: float = 0.9) -> Schedule:
    """lr(step) = (init - end) * (1 - min(step, decay_steps)/decay_steps)^power + end,
    the pytorch-polynomial-lr-decay formula (optax.polynomial_schedule)."""

    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), decay_steps) / decay_steps
        return (init_lr - end_lr) * frac**power + end_lr

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- g / ||g|| * max when
    ||g|| >= max. Returns the global norm (a device tensor, no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """A torch optimizer, its LR schedule and an optional global-norm clip,
    stepped as one unit: `step()` clips, updates the parameters, then
    advances the schedule (`sched`, a LambdaLR, keeps the update count).

    On the CPU the update takes the schedule's float and `zero_grad` sets
    the gradients to None. On CUDA the update reads its rate from `lrs`, a
    device tensor holding the rates of one call's updates (`load_lrs`, before
    the call; an update that no call loaded loads its own), and `zero_grad`
    zeroes the gradients in place, so that a captured step replays each call
    with that call's rates into the same gradient tensors."""

    def __init__(self, opt: torch.optim.Optimizer, sched, grad_clip: Optional[float] = None):
        self.opt, self.sched, self.grad_clip = opt, sched, grad_clip
        params = [p for g in opt.param_groups for p in g["params"]]
        self.lrs = torch.zeros(1, device=params[0].device) \
            if params and params[0].is_cuda else None
        self._first = self._loaded = 0  # the update count of lrs[0]; rates loaded

    def lr_table(self, k: int) -> list:
        """The learning rates of the next k updates, from the schedule at
        each update's count (LambdaLR's base_lr * lambda(count))."""
        (base,), (lam,) = self.sched.base_lrs, self.sched.lr_lambdas
        n = self.sched.last_epoch
        return [base * lam(n + i) for i in range(k)]

    def load_lrs(self, k: int) -> None:
        """Put the next k updates' rates into `lrs` (CUDA; never inside a
        capture, which would bake them in)."""
        if self.lrs.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("learning rates are loaded before a captured call, not inside it")
        if self.lrs.numel() < k:
            self.lrs = torch.zeros(k, device=self.lrs.device)
        for i, lr in enumerate(self.lr_table(k)):
            self.lrs[i].fill_(lr)
        self._first, self._loaded = self.sched.last_epoch, k

    def zero_grad(self) -> None:
        if self.lrs is None:
            self.opt.zero_grad(set_to_none=True)
            return
        grads = [p.grad for g in self.opt.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def step(self) -> None:
        if self.grad_clip is not None:
            grads = [p.grad for g in self.opt.param_groups for p in g["params"]
                     if p.grad is not None]
            clip_by_global_norm(grads, self.grad_clip)
        if self.lrs is None:
            self.opt.step()
        else:
            i = self.sched.last_epoch - self._first
            if not 0 <= i < self._loaded:
                self.load_lrs(1)
                i = 0
            group = self.opt.param_groups[0]
            rate, group["lr"] = group["lr"], self.lrs[i]
            try:
                self.opt.step()
            finally:
                group["lr"] = rate
        self.sched.step()

    def advance(self, k: int) -> None:
        """Count k updates that ran without `step` (a replayed call's)."""
        for _ in range(k):
            self.sched.step()


class MomentAdam(torch.optim.Optimizer):
    """Adam, or AdamW with `weight_decay` > 0, whose first moment
    `exp_avg` is stored in `moment_dtype`: optax.scale_by_adam(mu_dtype=...)
    then add_decayed_weights and the learning rate, in optax's arithmetic.
    With t the update count and mu the stored moment:
        mu' = (1 - b1) g + [b1' mu]                  (float32)
        nu' = (1 - b2) g^2 + b2 nu                   (float32)
        u   = (mu' / (1 - b1^t)) / (sqrt(nu' / (1 - b2^t)) + eps) [+ wd p]
        p  <- p + (-lr) u;  mu <- mu' rounded to its dtype
    where [b1' mu] is the product in mu's dtype with b1' = b1 rounded to it
    (0.8984375 for 0.9 in bf16: optax's `b1 * mu` is weakly typed). The
    update uses the unrounded float32 mu'. `exp_avg_sq` stays float32.
    t lives beside the parameters and the bias corrections are float32
    tensors formed there, as optax forms them; `lr` is a float or a
    one-element tensor there. So a step never waits for the host."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, moment_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.moment_dtype = moment_dtype

    def load_state_dict(self, state_dict) -> None:
        """torch's load, with each update count put beside its parameter."""
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            if "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            b1, b2 = group["betas"]
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            t = steps[0]
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            mu = torch._foreach_mul(grads, 1 - b1)
            # optax's weak-typed b1 * mu takes b1 in mu's dtype (0.8984375 in bf16)
            b1_mu = float(torch.tensor(b1, dtype=self.moment_dtype))
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
            torch._foreach_copy_(mus, mu)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            # the bias corrections as optax forms them: float32 1 - b**t
            torch._foreach_div_(mu, 1 - torch.pow(b1, t))
            denom = torch._foreach_div(nus, 1 - torch.pow(b2, t))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu, denom)
            if group["weight_decay"] > 0:
                torch._foreach_add_(mu, torch._foreach_mul(params, group["weight_decay"]))
            lr = group["lr"]
            torch._foreach_mul_(mu, -lr if torch.is_tensor(lr) else float(np.float32(-lr)))
            torch._foreach_add_(params, mu)


MOMENT_DTYPES = {"bfloat16": torch.bfloat16}


def moment_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """optim.moment_dtype -> the stored first moment's dtype (None: that of
    the parameters, in fused Adam); raises on a name the port lacks."""
    if name not in (None, "float32", *MOMENT_DTYPES):
        raise ValueError(f"optim.moment_dtype {name!r}: expected None, 'float32' or one "
                         f"of {sorted(MOMENT_DTYPES)}")
    return MOMENT_DTYPES.get(name)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, *,
                   schedule: Optional[Schedule] = None, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, grad_clip: Optional[float] = None,
                   moment_dtype: Optional[str] = None) -> Optimizer:
    """Adam (AdamW when weight_decay > 0, decoupled decay as optax.adamw) at
    `lr` or on `schedule`, with optional clip: the optimizer pair of the
    segmentor and the critic. Fused on CUDA; with moment_dtype "bfloat16"
    the first moment is stored in bf16 (`MomentAdam`), None and "float32"
    keep it in float32. The optimizer steps on the device without a host
    sync when its parameters are on CUDA (see `Optimizer`)."""
    mu_dtype = moment_dtype_of(moment_dtype)
    params = [p for p in params if p.requires_grad]
    fused = bool(params) and all(p.is_cuda for p in params)
    kw = dict(lr=1.0 if schedule is not None else lr, betas=(b1, b2), eps=1e-8,
              fused=fused or None, capturable=fused)
    if mu_dtype is not None:
        opt = MomentAdam(params, kw["lr"], kw["betas"], kw["eps"], weight_decay, mu_dtype)
    elif weight_decay > 0:
        opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    # LambdaLR scales the base lr (1.0 on a schedule) by schedule(step count)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule or (lambda _: 1.0))
    return Optimizer(opt, sched, grad_clip)
