"""The adversarial scribble trainer, on one device or data-parallel.

The port of `octave_tpu/train/trainer.py` (build_dataset :89-100,
Trainer.__init__ :107-214, init_state :217-276, load_pretrained_backbone
:278-300, fit :369-498, evaluate :501-549) for every architecture of the
family (`unet`, with or without encoder gating; `parallel_head`;
`parallel_head_gate` with its pair of critics), on the synthetic phantoms or
a ROSE / OCTA-500 folder (ROSE with per-head targets for the dual decoders),
with train-time augmentation, checkpoint and resume, a final save on SIGTERM
and an optional profiler trace, and the memory and lowering switches:
`train.remat` (the three parsers :34-86 turn its block modes into the
segmentor's block remat), `train.dense_groups` / `train.einsum_groups` (the
segmentor's grouped convs lowered when it is built), `optim.moment_dtype`
(both players' optimizers) and `train.steps_per_call` (:311-312, :412-483:
k batches per call, the step advancing by k, the log, checkpoint and eval
cadences by `_crossed`). The host never waits for a call unless it is
`dispatch_ahead` calls ahead of the device, or logs; it reads the SIGTERM
flag of a data-parallel run once per call. On CUDA each call of the step is
one replay of a captured CUDA graph (`train.steps.GraphedStep`; k steps per
graph with steps_per_call = k): a fit's first call runs eagerly and its
second is captured, after any restore; `graph_blocker` names the
configurations that stay eager, and the CPU is eager. On CUDA `evaluate`
scores each batch as one replay of a graph of the eval step
(`train.steps.StaticGraphs`, one graph per batch shape, the ragged last
batch its own), data parallelism included: the step has no collective
inside, and the counts are all-reduced after it.

With `train.data_parallel` the trainer is one rank of a process group that
already exists (`cli train` spawns one, or torchrun describes one): every
rank reads the same global batches and augmentation draws, keeps its rows
(`parallel.ddp.shard_rows`), runs the step with synchronised batch norm and
all-reduced gradients, and so computes what the full batch computes on one
device, as the JAX mesh does (:113, :314-365, :501-549). Rank 0 alone logs
and writes checkpoints; a SIGTERM on any rank stops every rank at the same
step; `evaluate` pads a ragged batch with zero-weight repeats and sums the
exact counts over ranks.
"""
from __future__ import annotations

import functools
import itertools
import logging
import signal
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from octave_tpu_torch.data import augment
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.data.preprocess import prepare_batch
from octave_tpu_torch.models.discriminator import DiscriminatorBlock
from octave_tpu_torch.models.resnest import lower_grouped_convs_
from octave_tpu_torch.models.segmentor import ARCHITECTURES, build_segmentor
from octave_tpu_torch.ops.norm import synchronize_batch_norm
from octave_tpu_torch.parallel import ddp
from octave_tpu_torch.serve import resolve_device
from octave_tpu_torch.train.schedule import make_optimizer, moment_dtype_of, polynomial_decay
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.train.steps import (
    GraphedStep,
    StaticGraphs,
    StepConfig,
    eval_counts,
    graph_blocker,
    make_eval_accumulate_step,
    make_multi_step,
    make_train_step,
    unpack_counts,
)
from octave_tpu_torch.utils import convert
from octave_tpu_torch.utils.checkpoint import CheckpointManager
from octave_tpu_torch.utils.config import Config
from octave_tpu_torch.utils.logging import MetricsLogger, StepTimer
from octave_tpu_torch.utils.metrics import AucAccumulator, ConfusionAccumulator
from octave_tpu_torch.utils.profiling import phase, span, trace

log = logging.getLogger("octave_tpu_torch")


def _parse_remat_blocks(remat) -> object:
    """train.remat -> the segmentors' remat_blocks field (the port's copy of
    octave_tpu/train/trainer.py::_parse_remat_blocks): 'block' -> True,
    'block-enc' -> 'encoder', 'block:<digits>' -> that set of decoder depths
    (the backbone always remated); anything else -> False (the step-level
    modes False / True / 'conv' need no model-side wiring). A '+conv' suffix
    and an 'e<digits>' encoder part are accepted and stripped."""
    if isinstance(remat, str) and remat.endswith("+conv"):
        remat = remat[: -len("+conv")]
    if remat == "block":
        return True
    if remat == "block-enc":
        return "encoder"
    if isinstance(remat, str) and remat.startswith("block:"):
        dec = remat[len("block:"):].split("e", 1)[0]
        idx = frozenset(int(c) for c in dec) if dec.isdigit() else frozenset()
        if not idx or not idx <= {0, 1, 2, 3, 4}:
            raise ValueError(f"remat {remat!r}: decoder indices must be 0-4")
        return idx
    if isinstance(remat, str) and remat.startswith("block"):
        raise ValueError(f"unknown remat mode {remat!r}")
    return False


def _parse_remat_enc_layers(remat) -> object:
    """The optional 'e<digits>' part of 'block:<dec>e<enc>[+conv]' -> the
    segmentors' remat_enc_layers field: the encoder layers (1-based, 1..4)
    that stay remated; no 'e' part -> True (all). The port's copy of
    octave_tpu/train/trainer.py::_parse_remat_enc_layers."""
    if not (isinstance(remat, str) and remat.startswith("block:")):
        return True
    if remat.endswith("+conv"):
        remat = remat[: -len("+conv")]
    parts = remat[len("block:"):].split("e", 1)
    if len(parts) == 1:
        return True
    enc = parts[1]
    idx = frozenset(int(c) for c in enc) if enc.isdigit() else frozenset()
    if not idx or not idx <= {1, 2, 3, 4}:
        raise ValueError(f"remat {remat!r}: encoder layers must be 1-4")
    return idx


def _remat_saves_convs(remat) -> bool:
    """A '+conv' suffix on a block mode ('block+conv', 'block:012+conv'): each
    region keeps its conv outputs (the segmentors' remat_save_convs). The
    port's copy of octave_tpu/train/trainer.py::_remat_saves_convs."""
    return isinstance(remat, str) and remat.startswith("block") \
        and remat.endswith("+conv")


def is_dual(cfg: Config) -> bool:
    """Whether the configured segmentor has two decoders (two heads)."""
    return cfg.model.architecture in ("parallel_head", "parallel_head_gate")


def pyramid_levels(architecture: str, gating_level: int) -> Dict[str, int]:
    """{critic name: levels of the attention pyramid it judges}: ResnestUNet
    gates depths gating_level..0; the gated dual decoders' main pyramid has 5
    levels when gating_level > 3, else gating_level + 1, and their "c"
    pyramid min(gating_level, 1) + 1; `parallel_head` has no pyramid."""
    if architecture == "unet":
        return {"main": min(gating_level, 4) + 1}
    if architecture == "parallel_head_gate":
        return {"main": 5 if gating_level > 3 else max(gating_level, 0) + 1,
                "c": min(gating_level, 1) + 1}
    return {}


def build_dataset(cfg: Config, split: str = "train"):
    d = cfg.data
    if d.dataset == "synthetic":
        return ds.SyntheticOcta(size=tuple(d.image_size), n=d.synthetic_n,
                                seed=cfg.train.seed + (0 if split == "train" else 1))
    if d.dataset == "rose":
        return ds.rose(d.root, d.subset, split, dual=is_dual(cfg))
    if d.dataset == "octa500":
        return ds.octa500(d.root, d.subset, split)
    raise ValueError(f"unknown dataset: {d.dataset}")


class Trainer:
    """Weak supervision (WPCE + ILD) and, with model.discriminator_depth > 0,
    the LS-GAN critic over each attention pyramid, on `device` (CUDA unless
    the caller passes "cpu"). `graphed`: whether `fit` runs each call of the
    step, and `evaluate` each batch of the eval step, as a CUDA-graph
    replay; None captures wherever `graph_blocker` allows on CUDA (the eval
    step everywhere on CUDA), False keeps both eager, True raises where the
    train step cannot be captured."""

    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 graphed: Optional[bool] = None):
        m, t = cfg.model, cfg.train
        # the remat and lowering specs raise the JAX ValueErrors here, before
        # any model is built
        self.remat_kw = dict(remat_blocks=_parse_remat_blocks(t.remat),
                             remat_save_convs=_remat_saves_convs(t.remat),
                             remat_enc_layers=_parse_remat_enc_layers(t.remat))
        moment_dtype_of(cfg.optim.moment_dtype)
        self.steps_per_call = max(1, int(t.steps_per_call))
        if m.architecture not in ARCHITECTURES:
            raise ValueError(f"unknown model.architecture {m.architecture!r}; expected "
                             f"{' | '.join(repr(a) for a in ARCHITECTURES)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_parallel = bool(cfg.train.data_parallel)
        self.world, self.rank = 1, 0
        if self.data_parallel:
            if not ddp.is_distributed():
                raise RuntimeError(
                    "train.data_parallel needs a process group: run `python -m "
                    "octave_tpu_torch.cli train train.data_parallel=true` (one process per "
                    "device) or start each rank under torchrun")
            self.world, self.rank = ddp.world(), ddp.rank()
            n = cfg.train.n_devices
            if n is not None and int(n) != self.world:
                raise ValueError(f"train.n_devices={n} but the process group has "
                                 f"{self.world} ranks")
            ddp.shard_rows(cfg.data.batch_size, self.rank, self.world)  # n divides B
        elif cfg.train.n_devices is not None:
            raise ValueError("train.n_devices needs train.data_parallel=true")
        self.gating_level = m.segmentor_gating_level
        # one critic per attention pyramid, its depth clamped to the levels
        # the model emits; a single pyramid keeps the one flat critic
        self.disc_depths: Dict[str, int] = {}
        levels = pyramid_levels(m.architecture, self.gating_level)
        if m.discriminator_depth > 0 and not levels:
            log.info("architecture %r emits no attention pyramid: training without the "
                     "adversarial branch", m.architecture)
        for name, n in levels.items():
            depth = min(m.discriminator_depth, n - 1)
            if 0 < depth < m.discriminator_depth:
                log.info("discriminator[%s] depth clamped %d -> %d (the %s pyramid has %d "
                         "levels)", name, m.discriminator_depth, depth, name, n)
            if m.discriminator_depth > 0 and depth > 0:
                self.disc_depths[name] = depth
        self.disc_depth = self.disc_depths.get("main", 0)
        self.step_cfg = StepConfig(
            num_classes=m.num_classes,
            weakly_supervise=m.weakly_supervise,
            lambda_ild=cfg.loss.lambda_ild,
            lambda_adv=cfg.loss.lambda_adv,
            ild_weights=cfg.loss.ild_weights,
            ild_stop_gradient=cfg.loss.ild_stop_gradient,
            ild_divergence=cfg.loss.ild_divergence,
            use_discriminator=bool(self.disc_depths),
            discriminator_depth=self.disc_depths.get("main", m.discriminator_depth),
            discriminator_depth_c=self.disc_depths.get("c", 1),
            compute_dtype=cfg.train.compute_dtype,
            remat=t.remat,
            dense_groups=t.dense_groups,
            einsum_groups=t.einsum_groups,
            data_parallel=self.data_parallel,
        )
        self.train_step = make_multi_step(make_train_step(self.step_cfg), self.steps_per_call)
        self.eval_step = make_eval_accumulate_step(m.num_classes)
        blocker = graph_blocker(self.step_cfg)
        if self.device.type != "cuda":
            blocker = f"no CUDA graphs on {self.device.type}"
        if graphed and blocker:
            raise ValueError(f"graphed=True, but the step cannot be captured: {blocker}")
        self.graphed = blocker is None if graphed is None else graphed
        self.eager_reason = "graphed=False" if graphed is False else blocker
        self.graphed_eval = self.device.type == "cuda" and graphed is not False

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh modules from train.seed (torch's reference initialisers,
        the segmentor first, then the critics in name order), their
        optimizers, and the noise generator on the device. The dual
        decoders' two critics are an `nn.ModuleDict` {"main", "c"} stepped by
        one optimizer. Every rank builds the same modules; under data
        parallelism the segmentor's batch norms are synchronised and each
        rank draws its own noise (`noise_seed`)."""
        with phase("octave.fit.init_state"):
            return self._init_state()

    def _init_state(self) -> TrainState:
        cfg, m, o = self.cfg, self.cfg.model, self.cfg.optim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.train.seed)
            segmentor = build_segmentor(m.architecture, m.num_classes, self.gating_level,
                                        encoder_gating=m.encoder_gating, **self.remat_kw)
            critics = {}
            for name, depth in sorted(self.disc_depths.items()):
                critics[name] = DiscriminatorBlock(
                    tuple(cfg.data.image_size), depth=depth, num_filters=m.num_filters,
                    instance_noise=m.instance_noise, label_noise=m.label_noise,
                    num_classes=m.num_classes)
        lower_grouped_convs_(segmentor, cfg.train.dense_groups, cfg.train.einsum_groups)
        segmentor = segmentor.to(self.device).to(memory_format=torch.channels_last).train()
        synchronize_batch_norm(segmentor, self.data_parallel)
        seg_opt = make_optimizer(
            segmentor.parameters(),
            schedule=polynomial_decay(o.seg_lr, o.end_lr, o.decay_steps, o.power),
            weight_decay=o.weight_decay, grad_clip=o.grad_clip, moment_dtype=o.moment_dtype)
        critic = critic_opt = None
        if critics:
            critic = critics["main"] if set(critics) == {"main"} else nn.ModuleDict(
                {name: critics[name] for name in self.disc_depths})
            critic = critic.to(self.device).to(memory_format=torch.channels_last).train()
            critic_opt = make_optimizer(
                critic.parameters(),
                schedule=polynomial_decay(o.disc_lr, o.end_lr, o.decay_steps, o.power),
                grad_clip=o.grad_clip, moment_dtype=o.moment_dtype)
        gen = torch.Generator(device=self.device).manual_seed(self.noise_seed(0))
        state = TrainState(segmentor=segmentor, seg_opt=seg_opt, critic=critic,
                           critic_opt=critic_opt, generator=gen)
        if m.pretrain:
            self.load_pretrained_backbone(state, m.weight_path)
        return state

    def noise_seed(self, step: int) -> int:
        """The seed of this rank's noise generator: rank 0 keeps the
        single-device seed, so one rank draws what one device draws; rank
        r > 0 folds r in and, when a run resumes at `step`, the step, since
        a checkpoint keeps rank 0's generator only (JAX folds the axis index
        into each step's keys, octave_tpu/train/steps.py:233-239)."""
        seed = self.cfg.train.seed + 1
        if self.rank == 0:
            return seed
        return (seed * 1_000_003 + self.rank) * 1_000_003 + step

    def load_pretrained_backbone(self, state: TrainState, path: str) -> TrainState:
        """Load a resnest50 classification .pth into the segmentor's encoder
        (the reference constructor's pretrained path); its `fc` is dropped.
        Every encoder tensor must be in the file."""
        tree = convert.convert_resnest50(convert.load_torch_state_dict(path), with_fc=False)
        sd = convert.backbone_to_unet_keys(tree)
        encoder = {k for k in state.segmentor.state_dict()
                   if k.startswith("encoder_") and "_gate." not in k
                   and not k.endswith("num_batches_tracked")}
        if set(sd) != encoder:
            raise ValueError(f"pretrained backbone does not cover the encoder: "
                             f"{sorted(encoder ^ set(sd))[:20]}")
        state.segmentor.load_state_dict(sd, strict=False)
        log.info("loaded %d pretrained backbone tensors from %s", len(sd), path)
        return state

    def shard(self, host_batch: Dict[str, np.ndarray],
              augment_draws: Optional[augment.Draws] = None):
        """This rank's rows of a global host batch and of its draws."""
        if not self.data_parallel:
            return host_batch, augment_draws
        rows = ddp.shard_rows(host_batch["image"].shape[0], self.rank, self.world)
        if augment_draws is not None:
            augment_draws = augment.Draws(*(None if d is None else d[rows]
                                            for d in augment_draws))
        return {k: v[rows] for k, v in host_batch.items()}, augment_draws

    def device_batch(self, host_batch: Dict[str, np.ndarray],
                     augment_draws: Optional[augment.Draws] = None) -> Dict[str, object]:
        """A host batch of `batch_iterator` -> model-ready tensors on the
        device, the second-head scribbles included when the batch has them."""
        cfg = self.cfg
        return prepare_batch(
            host_batch["image"], host_batch["scribble"], host_batch["mask"],
            size=tuple(cfg.data.image_size), num_classes=cfg.model.num_classes,
            depth=max(cfg.model.discriminator_depth, 1), in_channels=cfg.data.in_channels,
            augment_draws=augment_draws, scribble_c=host_batch.get("scribble_c"),
            device=self.device)

    def call_batch(self, host_batches: list, first_step: int,
                   aug_gen: Optional[torch.Generator] = None,
                   out: Optional[Dict[str, object]] = None) -> Dict[str, object]:
        """The device batch of one call of `train_step`: step first_step + i
        takes host_batches[i] (this rank's rows of it) with, when `aug_gen`
        is given, its augmentation draws from that generator seeded with
        (train.seed + 7919, the step), so that a resumed run, or one with
        another steps_per_call, draws what an uninterrupted one would. With
        several steps per call each leaf is the (k, b, ...) stack of the
        steps' batches. With `out` (a captured step's static input, of the
        same structure) the leaves are written into it and `out` returned."""
        with span("octave.fit.call_batch"):
            return self._call_batch(host_batches, first_step, aug_gen, out)

    def _call_batch(self, host_batches, first_step, aug_gen, out):
        cfg = self.cfg
        batches = []
        for i, host in enumerate(host_batches):
            draws = None
            if aug_gen is not None:
                aug_gen.manual_seed((cfg.train.seed + 7919) * 1_000_003 + first_step + i)
                draws = augment.draw(aug_gen, host["image"].shape[0],
                                     cfg.data.augment_intensity)
            batches.append(self.device_batch(*self.shard(host, draws)))

        def stack(leaves, into):
            if isinstance(leaves[0], (list, tuple)):
                return [stack(level, None if into is None else into[i])
                        for i, level in enumerate(zip(*leaves))]
            if into is None:
                return leaves[0] if len(leaves) == 1 else torch.stack(leaves)
            return into.copy_(leaves[0]) if len(leaves) == 1 else torch.stack(leaves, out=into)

        if out is None and len(batches) == 1:
            return batches[0]
        stacked = {k: stack([b[k] for b in batches], None if out is None else out[k])
                   for k in batches[0]}
        return stacked if out is None else out

    def step_call(self, state: TrainState):
        """What runs one call of the train step on `state` in `fit`: the
        eager step, or the state's `GraphedStep` of this trainer's step (a
        new one when the state has none, or one of another step)."""
        if not self.graphed:
            return self.train_step
        if not (isinstance(state.graph, GraphedStep) and state.graph.step is self.train_step):
            if state.graph is not None:
                state.graph.close()
            state.graph = GraphedStep(self.train_step, self.steps_per_call)
        return state.graph

    def eval_call(self, state: TrainState):
        """What scores one batch on `state` in `evaluate`: score(image,
        mask_onehot[, sample_weight]) -> the batch's packed counts
        (`train.steps.eval_counts`): eager, or the state's `StaticGraphs` of
        it (a new one when the state has none, or one of another segmentor
        or eval step)."""
        score = functools.partial(eval_counts, self.eval_step, state.segmentor)
        if not self.graphed_eval:
            return score
        graphs = state.eval_graphs
        if not (isinstance(graphs, StaticGraphs) and graphs.fn.args == score.args):
            if graphs is not None:
                graphs.close()
            state.eval_graphs = graphs = StaticGraphs(score, self.device)
        return graphs

    # ------------------------------------------------------------------
    def fit(self, state: Optional[TrainState] = None) -> TrainState:
        """Train `state` (a fresh `init_state()` by default) to train.steps.
        Each call of the step is the span `octave.fit.call` of a profile
        (`utils.profiling`), its children `octave.fit.next_batch` (the draw
        from the dataset), `octave.fit.call_batch`, `octave.fit.step`,
        `octave.fit.wait` (the run-ahead bound) and `octave.fit.log` (the
        log, checkpoint and eval cadences)."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        lead = self.rank == 0  # logs and writes; every rank steps

        # preemption: a SIGTERM ends the loop at a call boundary, and the
        # final save below keeps what was trained. Under data parallelism a
        # rank's flag is all-reduced with each call and read where the host
        # waits for that call anyway, so every rank stops at the same step
        preempted = {"flag": False}

        def on_sigterm(signum, frame):
            preempted["flag"] = True

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not on the main thread

        ckpt = None
        if cfg.train.checkpoint_dir:
            ckpt = CheckpointManager(cfg.train.checkpoint_dir)
            if ckpt.restore_latest(state) is not None:
                if state.generator is not None and self.rank > 0:
                    state.generator.manual_seed(self.noise_seed(state.step))
                if lead:
                    log.info("resumed from step %d", state.step)

        # a resumed run goes on with the batch an uninterrupted one takes
        # next; a call takes k = steps_per_call of them
        k = self.steps_per_call
        batches = ds.batch_iterator(build_dataset(cfg, "train"), cfg.data.batch_size,
                                    seed=cfg.train.seed, start=state.step)
        calls = iter(lambda: list(itertools.islice(batches, k)), [])
        # augmentation draws per step (`call_batch`), for the global batch on
        # every rank
        aug_gen = torch.Generator(device=self.device) if cfg.data.augment else None

        def crossed(step: int, every: int) -> bool:
            # a cadence boundary crossed by this call: step % every == 0 at k = 1
            return every > 0 and step // every > (step - k) // every

        run = self.step_call(state)
        if lead:
            log.info("train step: %s", f"one CUDA graph replay per call of {k} step(s)"
                     if self.graphed else f"eager ({self.eager_reason})")
        mlog = MetricsLogger(cfg.train.log_dir) if cfg.train.log_dir and lead else None
        timer = StepTimer()
        ahead = max(0, int(cfg.train.dispatch_ahead))
        inflight: deque = deque()
        window = []
        stop = False
        t0 = time.perf_counter()
        try:
            with trace(cfg.train.profile_dir):
                while True:
                    with span("octave.fit.call"):
                        with span("octave.fit.next_batch"):
                            host_batches = next(calls, None)
                        if (host_batches is None or state.step >= cfg.train.steps
                                or len(host_batches) < k):
                            break
                        if stop or (preempted["flag"] and not self.data_parallel):
                            log.warning("SIGTERM received: saving and stopping at step %d",
                                        state.step)
                            break
                        batch = self.call_batch(host_batches, state.step, aug_gen,
                                                out=run.inputs if self.graphed else None)
                        with span("octave.fit.step"):
                            losses = run(state, batch)
                        if cfg.train.debug_nans:
                            bad = [n for n, v in losses.items() if not bool(torch.isfinite(v))]
                            if bad:
                                raise FloatingPointError(
                                    f"non-finite {bad} at step {state.step}")
                        flag = None
                        if self.data_parallel:
                            flag = ddp.all_reduce_max(torch.full(
                                (1,), float(preempted["flag"]), device=self.device))
                        if self.device.type == "cuda":
                            # bound the host's run-ahead: wait for the oldest call
                            done = torch.cuda.Event()
                            done.record()
                            inflight.append((done, flag))
                            with span("octave.fit.wait"):
                                while len(inflight) > ahead:
                                    done, flag = inflight.popleft()
                                    done.synchronize()
                                    stop = stop or (flag is not None and bool(flag.item()))
                        elif flag is not None:
                            stop = stop or bool(flag.item())
                        with span("octave.fit.log"):
                            timer.tick()
                            window.append(losses)
                            step = state.step
                            if crossed(step, cfg.train.log_every):
                                if lead:
                                    mean = {n: float(torch.stack([l[n] for l in window])
                                                     .float().mean()) for n in window[-1]}
                                    dt = time.perf_counter() - t0
                                    ips = cfg.data.batch_size * k * len(window) / dt
                                    log.info("step %d  %s  %.1f img/s", step, "  ".join(
                                        f"{n}={v:.4f}" for n, v in mean.items()), ips)
                                    if mlog is not None:
                                        mlog.log(step, {**mean, "img_per_s_wall": ips,
                                                        **timer.stats(cfg.data.batch_size * k)},
                                                 prefix="train/")
                                window, t0 = [], time.perf_counter()
                            if ckpt is not None and crossed(step, cfg.train.checkpoint_every):
                                ckpt.save(step, state)
                            if crossed(step, cfg.train.eval_every):
                                self.evaluate(state)
        finally:
            if ckpt is not None:
                ckpt.save(state.step, state)
                ckpt.close()
            if mlog is not None:
                mlog.close()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state

    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState) -> Dict[str, float]:
        """Dataset-level Dice / IoU / accuracy / sensitivity / specificity /
        AUC on the test split, from per-batch device counts summed on the
        host in int64. Under data parallelism each rank scores its rows of
        every batch, a ragged batch padded to a multiple of the world with
        repeats of its last sample at weight 0, and the counts are summed
        over ranks: the result equals one device's exactly."""
        cfg = self.cfg
        conf = ConfusionAccumulator.empty_host()
        auc = AucAccumulator.empty_host()
        score = self.eval_call(state)
        for host_batch in ds.batch_iterator(build_dataset(cfg, "test"), cfg.data.batch_size,
                                            shuffle=False, epochs=1, drop_last=False):
            b = host_batch["image"].shape[0]
            pad = (-b) % self.world
            weight = None
            if pad:
                host_batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                              for k, v in host_batch.items()}
                weight = np.r_[np.ones(b, np.float32), np.zeros(pad, np.float32)]
            host_batch, _ = self.shard(host_batch)
            batch = self.device_batch(host_batch)
            inputs = [batch["image"], batch["mask_onehot"]]
            if weight is not None:
                rows = ddp.shard_rows(b + pad, self.rank, self.world)
                inputs.append(torch.as_tensor(weight[rows], device=self.device))
            counts = score(*inputs)
            if self.data_parallel:
                counts = ddp.all_reduce_sum(counts)
            c, a = unpack_counts(counts.cpu().numpy())
            conf = ConfusionAccumulator(*(x + y for x, y in zip(conf, c)))
            auc = AucAccumulator(*(x + y for x, y in zip(auc, a)))
        agg = {
            "dice": float(conf.dice()),
            "iou": float(conf.iou()),
            "accuracy": float(conf.accuracy()),
            "sensitivity": float(conf.sensitivity()),
            "specificity": float(conf.specificity()),
            "auc": float(auc.auc()),
        }
        if self.rank == 0:
            log.info("eval  %s", "  ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        return agg
