"""Train state: what one adversarial step reads and mutates.

The counterpart of `octave_tpu/train/state.py::TrainState`. JAX carries
parameters, batch stats, spectral u/v, optimizer states and the PRNG key as
one immutable pytree; here the two modules hold their parameters and
buffers (BN running stats, spectral u/v), the two optimizers hold their
moments and schedules, and one torch.Generator on the device feeds the
critic's noise layers. The step mutates them in place.

`graph` holds the step captured on this state (`train.steps.GraphedStep`,
on CUDA): it reads the state's tensors where they were at capture, so a
restore, which replaces optimizer states, drops it. `eval_graphs` holds the
eval step captured on the state's segmentor (`train.steps.StaticGraphs`,
one graph per batch shape); a restore drops it too.

`critic` is one DiscriminatorBlock, or, for the dual decoders' two
pyramids, an `nn.ModuleDict` {"main", "c"} of them under one optimizer (the
JAX state's dict of critics). The single critic stays flat, so its
checkpoints keep their keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from octave_tpu_torch.train.schedule import Optimizer


@dataclasses.dataclass
class TrainState:
    segmentor: nn.Module
    seg_opt: Optimizer
    critic: Optional[nn.Module] = None
    critic_opt: Optional[Optimizer] = None
    generator: Optional[torch.Generator] = None
    step: int = 0
    graph: Any = None
    eval_graphs: Any = None
