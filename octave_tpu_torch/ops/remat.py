"""Activation recomputation (remat) for the train step.

The counterpart of the JAX package's `jax.checkpoint` / `nn.remat` regions
(octave_tpu/train/steps.py:252-266, octave_tpu/models/resnest.py:599-640,
octave_tpu/models/segmentor.py:111-127): a region's forward keeps only its
inputs, and the backward runs the region again to get the tensors it needs.

  * `run` makes a region of `torch.utils.checkpoint.checkpoint(
    use_reentrant=False)`, which puts back the autocast state of the
    forward for the recompute. It does not stash the RNG state: no region
    draws random numbers (the segmentor has no dropout; the critic's noise
    lies outside every region), and putting a CUDA generator's state back
    is refused inside a CUDA-graph capture. In mode "conv" the region keeps the outputs
    of its convolutions instead of recomputing them: the counterpart of
    `save_only_these_names("conv_out")`, where the JAX package tags every
    conv output (`aten.convolution` here: `nn.Conv2d`, the block-diagonal
    dense lowering and `F.conv_transpose2d`) and the einsum lowering's
    output, which ends in no convolution and is tagged with `conv_out()`.
  * The recompute runs under a mark that `recomputing()` reads on the thread
    that runs it. Flax applies a region's `batch_stats` update once; torch
    would run a batch norm's update again in the recompute, so the norms of
    `ops/norm.py` read the mark and leave their running statistics alone
    there, while normalising by the batch's statistics as the forward did.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

_LOCAL = threading.local()
_CONV_OPS = (torch.ops.aten.convolution.default,)


def recomputing() -> bool:
    """Whether the calling thread runs a checkpoint's recompute."""
    return getattr(_LOCAL, "recompute", False)


@contextlib.contextmanager
def conv_out():
    """Ops run inside produce what the save-the-convs policy keeps, as the
    JAX package's `checkpoint_name(y, "conv_out")` tags y."""
    prev = getattr(_LOCAL, "tag", False)
    _LOCAL.tag = True
    try:
        yield
    finally:
        _LOCAL.tag = prev


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _CONV_OPS or getattr(_LOCAL, "tag", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _recompute(inner):
    prev = recomputing()
    _LOCAL.recompute = True
    try:
        with inner:
            yield
    finally:
        _LOCAL.recompute = prev


def run(mode, fn, *args):
    """fn(*args) under `mode`: False runs it as it is; True as one recomputed
    region (`torch.utils.checkpoint.checkpoint`, non-reentrant, which puts
    back the forward's autocast state for the recompute; `fn` draws no
    random numbers); "conv" as
    one that keeps its conv outputs and recomputes only what lies between
    them. Without autograd recording there is nothing to recompute, and it
    runs as it is."""
    if not mode or not torch.is_grad_enabled():
        return fn(*args)

    def contexts():
        if mode == "conv":
            fwd, rec = create_selective_checkpoint_contexts(_save_convs)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _recompute(rec)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False, context_fn=contexts)
