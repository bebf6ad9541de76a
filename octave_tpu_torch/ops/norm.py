"""Batch norm: the reference's two serving forms and cross-replica training.

`BatchNorm2d` is torch's BatchNorm2d (the reference's only norm layer) with
two extra modes:
  * eval, folded: once `folded_inference(model)` has marked it, its
    `weight`/`bias` hold the folded affine from `fold_batch_stats` and eval
    is y = x * weight + bias, as the JAX package's `folded_inference()` reads
    it (octave_tpu/ops/norm.py:58-105);
  * training, synchronised: once `synchronize_batch_norm(model)` has marked
    it (a model built for data parallelism, at any world size), the batch
    statistics are those of the global batch, by the JAX formula
    (octave_tpu/ops/norm.py:123-138): the per-channel mean and mean of
    squares accumulated in float64 (the input is read as it is, never
    copied), summed over ranks and divided by the world size (equal
    shards), var = max(mean2 - mean^2, 0), and the running variance
    unbiased by the global count. In float32 sums, mean2 - mean^2 cancels:
    at 32² after two steps the losses of 2 ranks drifted 1.4e-4 relative
    from one device's (torch's two-pass statistics); float64 sums hold them
    within 1e-5 (tests/test_torch_parallel.py). Its backward is batch norm's
    analytic gradient over the global batch, whose two per-channel sums are
    all-reduced: what autograd through the formula and a differentiable
    all-reduce computes, in about half the full-size passes.
    `torch.nn.SyncBatchNorm` is not used: it refuses CPU tensors and its
    Welford statistics are not this formula.
Otherwise training uses torch's own forward.

Inside a checkpoint's recompute (`ops/remat.py`) a training norm normalises
by the batch's statistics as the forward did but leaves the running
statistics as the forward left them, as Flax applies a remat region's
`batch_stats` update once: the cuDNN path runs the same op with an update
factor of 0 (running * 1 + batch * 0 is running, exactly) and without the
`num_batches_tracked` increment; the synchronised path still all-reduces its
statistics, on every rank in the same order, and skips the update.

`bn_act` is the model's batch norm -> [residual join ->] ReLU tail: one
pass of the fused kernel (`ops/kernels/bn_act.py`) where the norms are
folded eval norms on CUDA and no gradient is recorded, else the same ops as
the module chain, bit for bit equal.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.ops import remat
from octave_tpu_torch.ops.kernels.bn_act import fused_bn_act
from octave_tpu_torch.parallel import ddp

EPS = 1e-5


def fold_batch_stats(state_dict: Dict[str, torch.Tensor],
                     eps: float = EPS) -> Dict[str, torch.Tensor]:
    """Fold each BN's running stats into its affine:
        weight' = weight * rsqrt(running_var + eps);  bias' = bias - running_mean * weight'.
    Returns a new state dict; the stats are kept but no longer read once the
    model runs under `folded_inference`."""
    out = dict(state_dict)
    for key, mean in state_dict.items():
        if not key.endswith(".running_mean"):
            continue
        base = key[: -len("running_mean")]
        var = state_dict.get(base + "running_var")
        w, b = base + "weight", base + "bias"
        if var is None or w not in state_dict or b not in state_dict:
            continue
        scale = state_dict[w] * torch.rsqrt(var + eps)
        out[b] = state_dict[b] - mean * scale
        out[w] = scale
    return out


_DIMS = (0, 2, 3)
_CHANNEL = (1, -1, 1, 1)


class _SyncBatchNorm(torch.autograd.Function):
    """Training batch norm of an NCHW shard over the global batch of every
    rank: (x, weight, bias, eps) -> (y, batch mean, biased batch var), the
    last two without gradient. Per-channel sums accumulate in float64;
    full-size passes run in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        acc = torch.float64
        n = x.numel() // x.shape[1]
        world = ddp.world()
        if x.dtype == acc:
            mean2 = (x * x).mean(_DIMS)
        else:  # the norm reads x as it is: each square is formed in float64
            mean2 = torch.linalg.vector_norm(x, 2, _DIMS, dtype=acc).square_().div_(n)
        stats = torch.stack([x.mean(_DIMS, dtype=acc), mean2])
        if world > 1:
            stats = ddp.all_reduce_sum(stats).div_(world)
        mean, mean2 = stats
        var = torch.addcmul(mean2, mean, mean, value=-1).clamp_(min=0.0)
        invstd = (var + eps).rsqrt_()
        scale = weight.to(acc) * invstd
        shift = torch.addcmul(bias.to(acc), mean, scale, value=-1)
        y = torch.addcmul(shift.to(x.dtype).view(_CHANNEL), x, scale.to(x.dtype).view(_CHANNEL))
        ctx.save_for_backward(x, mean, invstd, scale)
        ctx.n_global = n * world
        ctx.weight_dtype = weight.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _mean, _var):
        # y = (x - mean) * invstd * w + b over the global batch:
        #   dx = w invstd (gy - sum(gy) / N - (x - mean) invstd^2 sum(gy (x - mean)) / N)
        # with both sums global; dw and db take this rank's sums, which
        # the gradient all-reduce then averages
        x, mean, invstd, scale = ctx.saved_tensors
        acc = mean.dtype
        sums = torch.stack([gy.sum(_DIMS, dtype=acc), (gy * x).sum(_DIMS, dtype=acc)])
        sums[1].addcmul_(mean, sums[0], value=-1)  # sum(gy (x - mean))
        total = ddp.all_reduce_sum(sums) if ddp.world() > 1 else sums
        b = scale * invstd * invstd * total[1] / -ctx.n_global
        c = torch.addcmul(scale * total[0] / -ctx.n_global, mean, b, value=-1)
        dt = x.dtype
        dx = torch.addcmul(torch.addcmul(c.to(dt).view(_CHANNEL), gy, scale.to(dt).view(_CHANNEL)),
                           x, b.to(dt).view(_CHANNEL))
        wdt = ctx.weight_dtype
        return dx, (sums[1] * invstd).to(wdt), sums[0].to(wdt), None


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d whose eval forward can read a folded affine and
    whose training statistics can span every rank."""

    def __init__(self, num_features: int, eps: float = EPS, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.folded = False
        self.synchronized = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if self.synchronized:
                return self._synchronized(x)
            if remat.recomputing():
                return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                    self.bias, True, 0.0, self.eps)
            return super().forward(x)
        shape = (1, -1, 1, 1)
        if self.folded:
            return torch.addcmul(self.bias.view(shape), x, self.weight.view(shape))
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)

    def _synchronized(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps)
        if remat.recomputing():
            return y
        n = x.numel() // x.shape[1] * ddp.world()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), m)
            self.running_var.lerp_((var * (n / max(n - 1, 1))).to(self.running_var.dtype), m)
            self.num_batches_tracked.add_(1)
        return y

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval BN as a float32 per-channel (scale, bias), raw or folded."""
        if self.folded:
            return self.weight.float(), self.bias.float()
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale


def bn_act(bn: BatchNorm2d, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
           res_bn: Optional[BatchNorm2d] = None, relu_inplace: bool = False) -> torch.Tensor:
    """relu(bn(x) [+ res_bn(residual) | + residual]); on CUDA in folded eval it consumes x.

    Where every norm is a folded eval norm, x is on CUDA and no gradient is
    recorded, one launch of `fused_bn_act` computes it and writes it over x:
    the caller passes a tensor that nothing reads afterwards (the model's
    callers pass a conv's output; the residual may be x itself, each
    element is read before it is written). Tensors the kernel does not
    take (not channels-last, mixed dtypes) raise its ValueError. Everywhere
    else (training, unfolded eval, the CPU, a gradient to record) it runs
    the chain and leaves x as it is: bn(x), then res_bn(residual), the add
    and `F.relu`, in place on bn's output with `relu_inplace`, as the
    `nn.ReLU(inplace=True)` it stands for: the ops the module chain ran."""
    norms = (bn,) if res_bn is None else (bn, res_bn)
    if (x.is_cuda and not torch.is_grad_enabled()
            and all(m.folded and not m.training for m in norms)):
        args = (x, bn.weight, bn.bias)
        if residual is not None:
            args += (residual,) if res_bn is None else (residual, res_bn.weight, res_bn.bias)
        return fused_bn_act(*args, out=x)
    y = bn(x)
    if residual is not None:
        y = y + (residual if res_bn is None else res_bn(residual))
    return F.relu(y, inplace=relu_inplace)


def folded_inference(model: nn.Module, enabled: bool = True) -> nn.Module:
    """Mark every BatchNorm2d of `model` as holding folded weights (or not)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.folded = enabled
    return model


def synchronize_batch_norm(model: nn.Module, enabled: bool = True) -> nn.Module:
    """Mark every BatchNorm2d of `model` to take its training statistics
    over every rank of the default process group (or not)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.synchronized = enabled
    return model
