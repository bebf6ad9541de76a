"""The weakly-supervised adversarial train step and the streaming eval step.

The port of `octave_tpu/train/steps.py` (adapt_segmentor_output :45-73,
StepConfig :76-139, make_train_step :150-419, make_multi_step :422-454,
_eval_forward :457-465, make_eval_step :468-480, make_eval_accumulate_step
:483-503), for every segmentor of the family and one critic or the dual
decoders' pair of critics. One step:

    pyramids, agg maps = segmentor(x)                 (BN stats update once)
    L_seg = sum over heads WPCE(softmax(agg_h), scribble_h)
            + l_ild sum over pyramids ILD(pyramid) + l_adv sum over critics G(D(pyramid))
    segmentor optimizer steps
    L_D = sum over critics LSGAN(D(real pyramid), D(detached pyramid))
    critic optimizer steps (one optimizer over every critic, one global clip)

Head 0 takes `scribble_onehot`, later heads `scribble_onehot_c` when the
batch carries it. The critic is a DiscriminatorBlock judging pyramid 0, or
an `nn.ModuleDict` {"main", "c"} whose critics judge pyramids 0 and 1 at
depths discriminator_depth and discriminator_depth_c.

What `stop_gradient` and the discarded `mutable` collections do in the JAX
step, the port does explicitly:
  * the generator phase runs each critic with its parameters frozen
    (requires_grad off), so L_seg leaves no gradient on them, and with
    `update=False`, so its power iterations are thrown away;
  * the critic phase sees the attention pyramids detached and, for each
    critic in order, from the step's original u/v, iterates D(fake) then
    D(real), storing both.
With compute_dtype 'bfloat16' or 'float16' both forwards run under
torch.autocast in that dtype (master weights stay float32, and their
gradients come back float32) and every loss is taken on float32 casts of the
pyramids and the agg maps, as the JAX step casts them. float16 has no loss
scaling, as the JAX step has none.

The memory and lowering switches (:95-138, :195-270):
  * `remat` True runs the segmentor forward as one recomputed region, "conv"
    as one that keeps its conv outputs (`ops/remat.py`); the "block..."
    modes add no region here: the segmentor was built with block remat
    (`models/segmentor.py`, as `train.trainer.Trainer` builds it);
  * `dense_groups` / `einsum_groups` lower the segmentor's selected grouped
    convs (`models/resnest.py::lower_grouped_convs_`), once, at its first
    step (the Trainer lowers them when it builds the model, so that eval
    runs them too).
`make_multi_step` runs k steps per call on a stack of k batches.

On CUDA a call of the step (one step, or make_multi_step's k) runs as one
replay of a captured CUDA graph (`GraphedStep`), the counterpart of the
JAX package's jax.jit(step) (octave_tpu/train/trainer.py:326) and of the
one dispatch of its k-step call (:422-454); `graph_blocker` says which
configurations stay eager. The same step body is captured: its forwards
run under autocast without the cast cache (a captured cast would not be
redone), the optimizers take their learning rates from the device
(`train.schedule.Optimizer`) and the critic draws from the state's
generator, which the graph advances on each replay. `CapturedCall` is the
capture itself (warm-up, capture, replay, launch counts), which
`GraphedStep` and `StaticGraphs` share: the latter runs a function of
tensors as one replay per call of a graph per input shape, with inputs
copied in and outputs copied out, as `serve.Predictor`'s forwards and
`Trainer.evaluate`'s eval step (`eval_counts`, the counterpart of
octave_tpu/train/trainer.py:328 jax.jit(acc)) run on CUDA.

The step's spans (`utils.profiling.span`, entered only while a profiler
records): `octave.step.segmentor` around the segmentor's forward, losses,
backward and update, holding `octave.step.generator.<critic>` for each
critic's judgment of the live pyramid; then `octave.step.critic.<critic>`
around each critic's forwards and loss (their one backward and update
follow). A replay runs no Python, so under a profiler they show in eager
calls (the first call before a capture, every step that stays eager) and
at a capture, never at a replay.

With `data_parallel` each rank runs the step on its shard of the global
batch (:233-239, 344-346, 398-400): the WPCE class counts are global, each
player's gradients are all-reduced to their mean between backward and its
optimizer step (so a global clip sees the mean gradient, as optax does
after `pmean`), and the losses are all-reduced to their mean. The segmentor
is expected to be built with synchronised batch norm
(`ops.norm.synchronize_batch_norm`) and each rank to draw its own noise.
Spectral u/v need nothing: every rank iterates them from the same weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from octave_tpu_torch.losses.gan import ls_discriminator_loss, ls_generator_loss
from octave_tpu_torch.losses.segmentor import (
    dice_loss,
    interlayer_divergence,
    interlayer_divergence_pooled,
    weighted_partial_ce,
)
from octave_tpu_torch.models.resnest import dense_groups_include, lower_grouped_convs_
from octave_tpu_torch.ops import remat
from octave_tpu_torch.ops.common import conv_transpose_impl
from octave_tpu_torch.ops.kernels import add_launches, record_launches
from octave_tpu_torch.parallel import ddp
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.utils import profiling
from octave_tpu_torch.utils.metrics import (
    AucAccumulator,
    ConfusionAccumulator,
    eval_step_metrics,
)

_COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """train.compute_dtype -> the autocast dtype (None: plain float32)."""
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}; expected one of "
                         f"{', '.join(repr(k) for k in _COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def adapt_segmentor_output(out) -> Tuple[tuple, tuple]:
    """Any family forward's output -> (pyramids, agg_maps), tuples of
    attention pyramids (possibly empty) and per-head agg maps:
      * ResnestUNet                           (atts, agg, x_4)
      * ResnestUNet(encoder_gating=True)      (gates, atts, agg, x_4); the
        gates feed the classification path, not the losses
      * ResnestUnetParallelHead               agg maps stacked (2, b, h, w, c)
      * ResnestUnetParallelHeadAttentionGate  ((atts, atts_c), stacked)"""
    if torch.is_tensor(out):
        return (), tuple(out.unbind(0))
    if len(out) == 2:
        (atts, atts_c), stacked = out
        return (tuple(atts), tuple(atts_c)), tuple(stacked.unbind(0))
    if len(out) == 4:
        _, attentions, agg_map, _ = out
        return (tuple(attentions),), (agg_map,)
    attentions, agg_map, _ = out
    return (tuple(attentions),), (agg_map,)


# the pyramid each critic judges
_CRITIC_PYRAMID = {"main": 0, "c": 1}


def _critics(critic) -> list:
    """[(name, DiscriminatorBlock)] of a state's critic: one block is "main"."""
    if critic is None:
        return []
    if isinstance(critic, nn.ModuleDict):
        return list(critic.items())
    return [("main", critic)]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Loss wiring (defaults follow the reference facade, octa.py:51-56)."""

    num_classes: int = 2
    weakly_supervise: bool = True
    lambda_ild: float = 1.0
    lambda_adv: float = 1.0
    ild_weights: Optional[Tuple[float, ...]] = None
    ild_stop_gradient: bool = False
    ild_divergence: str = "KLD"  # KLD runs the pooled form (no full-res posteriors)
    use_discriminator: bool = True
    discriminator_depth: int = 4
    # depth of the "c" critic, on the dual decoders' second pyramid (at most
    # 2 levels: the `_c` branch gates depths 1 and 0)
    discriminator_depth_c: int = 1
    supervise_attention0: bool = False  # the supervised loss on atts[0] too
    compute_dtype: Optional[str] = None  # None | 'float32' | 'bfloat16' | 'float16'
    # False | True (one region over the segmentor forward) | 'conv' (the
    # same, keeping the conv outputs) | 'block' | 'block-enc' |
    # 'block:<decoder depths>[e<encoder layers>]' and any of those with
    # '+conv' (block remat, which the model carries)
    remat: Any = False
    # None | 'all' | 'decoder' | 'decoder:<digits>' | 'enc' | '+'-combos:
    # grouped convs as block-diagonal dense convs / as shifted batched
    # matmuls (einsum wins where both select a conv)
    dense_groups: Optional[str] = None
    einsum_groups: Optional[str] = None
    data_parallel: bool = False  # one shard per rank of the default process group


def _supervised(cfg: StepConfig, probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if cfg.weakly_supervise:
        return weighted_partial_ce(probs, target, cfg.num_classes, manual=True,
                                   global_counts=cfg.data_parallel)
    return dice_loss(probs, target)


def _ild(cfg: StepConfig, pyramid) -> torch.Tensor:
    weights = list(cfg.ild_weights) if cfg.ild_weights else None
    if cfg.ild_divergence == "KLD":
        return interlayer_divergence_pooled(pyramid, weights=weights,
                                            stop_gradient=cfg.ild_stop_gradient)
    return interlayer_divergence(pyramid, weights=weights, stop_gradient=cfg.ild_stop_gradient,
                                 divergence=cfg.ild_divergence)


def make_train_step(cfg: StepConfig) -> Callable[[TrainState, Dict[str, Any]],
                                                 Dict[str, torch.Tensor]]:
    """The fused GAN step. batch: image (b,h,w,3), scribble_onehot (b,h,w,c),
    optional scribble_onehot_c (later heads' target) and, with a critic,
    mask_pyramid (finest first). Returns the losses as detached device
    tensors (reading them is the caller's only host sync)."""
    cdtype = compute_dtype(cfg.compute_dtype)
    depth_of = {"main": cfg.discriminator_depth, "c": cfg.discriminator_depth_c}
    region = step_remat(cfg.remat)
    for spec in (cfg.dense_groups, cfg.einsum_groups):
        if spec is not None:
            dense_groups_include(spec)  # raises on a bad spec, before any step
    lowered = weakref.WeakSet()

    def loss_dtype(t: torch.Tensor) -> torch.Tensor:
        # losses in float32 under autocast; otherwise in the model's dtype
        return t.float() if cdtype is not None else t

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        seg = state.segmentor
        critics = _critics(state.critic) if cfg.use_discriminator else []

        def amp():
            # without the cast cache, which a captured step may not use
            return torch.autocast(batch["image"].device.type, dtype=cdtype or torch.bfloat16,
                                  enabled=cdtype is not None, cache_enabled=False)

        def judged(pyramids, name):
            return list(pyramids[_CRITIC_PYRAMID[name]][: depth_of[name] + 1])

        if seg not in lowered and (cfg.dense_groups or cfg.einsum_groups):
            lower_grouped_convs_(seg, cfg.dense_groups, cfg.einsum_groups)
            lowered.add(seg)
        with profiling.span("octave.step.segmentor"):
            seg.train()
            state.seg_opt.zero_grad()
            with amp():
                out = remat.run(region, seg, batch["image"])
            pyramids_native, agg_maps = adapt_segmentor_output(out)
            pyramids = tuple(tuple(loss_dtype(a) for a in p) for p in pyramids_native)
            target_c = batch.get("scribble_onehot_c", batch["scribble_onehot"])
            l_sup = sum(_supervised(cfg, torch.softmax(loss_dtype(a), dim=-1),
                                    batch["scribble_onehot"] if head == 0 else target_c)
                        for head, a in enumerate(agg_maps))
            if cfg.supervise_attention0 and pyramids:
                l_sup = l_sup + _supervised(cfg, pyramids[0][0], batch["scribble_onehot"])
            losses = {"loss_sup": l_sup}
            total = l_sup
            if cfg.lambda_ild > 0 and any(len(p) > 1 for p in pyramids):
                l_ild = sum(_ild(cfg, p) for p in pyramids if len(p) > 1)
                losses["loss_ild"] = l_ild
                total = total + cfg.lambda_ild * l_ild
            if critics:
                # generator phase: each critic judges its live pyramid with its
                # parameters frozen and its power iterations discarded
                l_adv = 0
                for name, critic in critics:
                    critic.train()
                    critic.requires_grad_(False)
                    try:
                        with profiling.span(f"octave.step.generator.{name}"), amp():
                            y_fake = critic(judged(pyramids_native, name), state.generator,
                                            update=False)
                    finally:
                        critic.requires_grad_(True)
                    l_adv = l_adv + ls_generator_loss(loss_dtype(y_fake))
                losses["loss_adv"] = l_adv
                total = total + cfg.lambda_adv * l_adv
            losses["loss_seg_total"] = total
            total.backward()
            if cfg.data_parallel:
                ddp.all_reduce_mean_(p.grad for p in seg.parameters())
            state.seg_opt.step()

        if critics:
            state.critic_opt.zero_grad()
            l_d = 0
            for name, critic in critics:
                with profiling.span(f"octave.step.critic.{name}"):
                    fake = [a.detach() for a in judged(pyramids_native, name)]
                    real = [p.to(cdtype) if cdtype else p
                            for p in batch["mask_pyramid"][: depth_of[name] + 1]]
                    with amp():
                        y_fake = critic(fake, state.generator, update=True)
                        y_real = critic(real, state.generator, update=True)
                    l_d = l_d + ls_discriminator_loss(loss_dtype(y_real), loss_dtype(y_fake))
            l_d.backward()
            if cfg.data_parallel:
                ddp.all_reduce_mean_(p.grad for p in state.critic.parameters())
            state.critic_opt.step()
            losses["loss_disc"] = l_d
        state.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        if cfg.data_parallel:
            names = list(losses)
            mean = ddp.all_reduce_sum(torch.stack([losses[k] for k in names])) / ddp.world()
            losses = dict(zip(names, mean.unbind(0)))
        return losses

    return train_step


def step_remat(mode):
    """StepConfig.remat -> the region the step puts around the segmentor
    forward (`ops.remat.run`'s mode): True and 'conv' as they are, nothing
    for False and the block modes. Raises on anything else (the JAX step
    would take any other true value for True)."""
    if mode is None or mode is False:
        return False
    if mode is True or mode == "conv":
        return mode
    if isinstance(mode, str) and mode.startswith("block"):
        return False
    raise ValueError(f"unknown remat mode {mode!r}")


def make_multi_step(train_step, k: int):
    """k train steps per call (octave_tpu/train/steps.py:422-454): `batches`
    holds each batch leaf with a leading (k, ...) axis (a stack of k
    per-step batches); step i runs on index i. Returns the losses averaged
    over the k steps, on the device."""
    if k <= 1:
        return train_step

    def pick(leaf, i):
        return [pick(x, i) for x in leaf] if isinstance(leaf, (list, tuple)) else leaf[i]

    def multi_step(state: TrainState, batches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        total = None
        for i in range(k):
            losses = train_step(state, {name: pick(v, i) for name, v in batches.items()})
            total = losses if total is None else {n: total[n] + v for n, v in losses.items()}
        return {n: v / k for n, v in total.items()}

    return multi_step


def graph_blocker(cfg: StepConfig) -> Optional[str]:
    """Why a step of this configuration runs eagerly on CUDA, or None when
    `GraphedStep` captures it. Every `remat` mode and `compute_dtype`
    captures; `data_parallel` stays eager. Raises on a remat mode or dtype
    the step does not know."""
    step_remat(cfg.remat)
    compute_dtype(cfg.compute_dtype)
    if cfg.data_parallel:
        return ("data_parallel: its all-reduces and synchronised batch norm run eagerly "
                "until the captured step can be held to the eager one on a machine with "
                "two cards (ROADMAP A.5b)")
    return None


# eager calls before the capture: the first builds the optimizer states and
# the gradients, compiles the Triton kernels, picks cuDNN's algorithms and
# fills what a module caches on its first call, which a capture must find done
GRAPH_WARMUP_CALLS = 1
# one capture at a time in the process: a capture's kernel launches go to one
# tally (`ops.kernels.record_launches`)
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _own_cublas_workspaces():
    """Drop the process's cached cuBLAS workspaces (one per handle and
    stream, kept for good) before and after a warm-up or a capture, as
    torch's own graph trees do. The ones made inside are then allocated in
    the pool and freed back into it: none holds a block of the pool beyond
    the pool's life, and the graph uses no workspace of another pool or of
    the general cache, which a later drop would free under it."""
    torch._C._cuda_clearCublasWorkspaces()
    try:
        yield
    finally:
        torch._C._cuda_clearCublasWorkspaces()


class CapturedCall:
    """fn() on CUDA as one replay of a captured CUDA graph per call.

    The first GRAPH_WARMUP_CALLS calls run fn eagerly on a side stream; the
    next call captures fn on that stream and replays it; every later call
    replays. fn reads and writes only tensors that stay where they are (its
    static inputs, parameters and buffers); after a replay its output is the
    graph's static output, which the next replay overwrites. The capture
    registers `generator` (None: none), so that every replay draws fresh
    numbers from it, and records the kernel launches that each replay then
    adds to the wrappers' counts. Warm-ups and the capture are the phases
    `octave.graph.warmup` and `octave.graph.capture` (`utils.profiling`), a
    capture raises the counter `graph.captures`, and a replay is the span
    `octave.graph.replay`.

    The warm-up and the capture allocate in one `torch.cuda.MemPool`, `pool`
    (None: a pool of its own), so that the capture reuses the blocks the
    warm-up freed instead of holding a second copy of them beside the
    warm-up's in the general cache. Calls that share a pool share their side
    `stream` too (the caching allocator reuses a freed block only on the
    stream it was allocated on), and must run one at a time: a block of one
    graph is free to the others' warm-ups and captures. The capture lets
    other threads work on the device meanwhile ("thread_local"). A failed
    capture raises; nothing falls back to eager."""

    def __init__(self, fn: Optional[Callable[[], Any]], pool: Optional[torch.cuda.MemPool] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.fn, self.pool, self.stream = fn, pool, stream
        self.generator = None
        self.calls = 0
        self.graph = self.out = None
        self.launches: dict = {}  # {kernel wrapper: launches in one replay}

    def __call__(self):
        self.calls += 1
        if self.graph is None:
            main = torch.cuda.current_stream()
            if self.pool is None:
                self.pool, self.stream = torch.cuda.MemPool(), torch.cuda.Stream()
            self.stream.wait_stream(main)
            if self.calls <= GRAPH_WARMUP_CALLS:
                with profiling.phase("octave.graph.warmup"), _own_cublas_workspaces(), \
                        torch.cuda.stream(self.stream), torch.cuda.use_mem_pool(self.pool):
                    out = self.fn()
                main.wait_stream(self.stream)
                return out
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            # the phase's span opens before the capture begins and closes
            # after it ends: nothing of it is in the graph
            with profiling.phase("octave.graph.capture"), _CAPTURE_LOCK, \
                    record_launches() as launches, _own_cublas_workspaces(), \
                    torch.cuda.graph(graph, pool=self.pool.id, stream=self.stream,
                                     capture_error_mode="thread_local"):
                out = self.fn()
            profiling.count("graph.captures")
            self.graph, self.out, self.launches = graph, out, launches
        with profiling.span("octave.graph.replay"):
            self.graph.replay()
            add_launches(self.launches)
        return self.out

    def close(self) -> None:
        """Wait for the device, then drop the graph and its buffers."""
        if self.stream is not None:
            torch.cuda.synchronize(self.stream.device)
        self.graph = self.out = None


class GraphedStep(CapturedCall):
    """Each call of `step` (a train step, or make_multi_step's k steps) on
    CUDA as one replay of a captured CUDA graph (`CapturedCall`), the
    state's noise generator registered so that every replay draws fresh
    noise.

    The first call's batch becomes the static input (`inputs`), which every
    later call must pass again, written with its new data
    (`Trainer.call_batch(out=...)`). Before a call each optimizer loads the
    learning rates of its k updates; after a replay the host counts the k
    updates and steps. A call returns a copy of its losses (the graph's, or
    the warm-up's, which lie in the graph's memory pool).

    The graph reads the state's tensors where they were at capture: replace
    none of them (`utils.checkpoint.load_state_dict_into` drops the graph)."""

    def __init__(self, step: Callable, k: int = 1):
        super().__init__(None)
        self.step, self.k = step, k
        self.inputs = None

    def __call__(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        opts = [opt for opt in (state.seg_opt, state.critic_opt) if opt is not None]
        for opt in opts:
            opt.load_lrs(self.k)
        if self.inputs is None:
            self.inputs = batch
            self.fn = functools.partial(self.step, state, batch)
            self.generator = state.generator
        elif batch is not self.inputs:
            raise ValueError("a graphed call reads its static input: pass `inputs`, "
                             "written with the call's batch (Trainer.call_batch(out=...))")
        replaying = self.graph is not None
        losses = super().__call__()
        if replaying:  # the eager and the capturing call count in the step itself
            for opt in opts:
                opt.advance(self.k)
            state.step += self.k
        return _copied(losses)

    def close(self) -> None:
        super().close()
        self.fn = self.inputs = None


def _copied(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The losses as new device tensors (one copy, no host sync)."""
    stacked = torch.stack(list(losses.values()))
    return dict(zip(losses, stacked.unbind(0)))


def graph_context() -> tuple:
    """The process-wide switches that a captured forward reads while it runs
    and a graph would freeze: the ConvTranspose lowering, TF32 in matmuls
    and in cuDNN, and the deterministic-algorithm settings."""
    return (conv_transpose_impl(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


class StaticGraphs:
    """fn(*tensors) on a CUDA device, one `CapturedCall` per signature: the
    inputs' shapes and dtypes, and `graph_context()` (a change of those
    switches captures anew, as jax.jit compiles anew when its precision
    settings change).

    A call copies its inputs into that signature's static inputs on the
    current stream (so a replay still in flight keeps its own inputs), runs
    the CapturedCall (eager at first, then captured and replayed), and
    returns fn's output (a tensor or a tuple of tensors) copied out of the
    pool on the current stream: tensors that no later replay, warm-up or
    capture touches. So every graph of one object shares one memory pool and
    one side stream (each reuses the memory the others freed) and their
    calls run in order: a lock makes each call's copy, run and copy-out one
    step for the threads that share the object, and a capture lets other
    threads work on the device meanwhile (a BatchServer's resolver downloads
    while its worker captures). `captures` counts the graphs captured."""

    def __init__(self, fn: Callable, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.fn, self.device = fn, device
        self.graphs: Dict[tuple, Tuple[tuple, CapturedCall]] = {}
        self.pool = self.stream = None
        self.captures = 0
        self._lock = threading.Lock()

    def __call__(self, *inputs: torch.Tensor):
        ok = all(torch.is_tensor(t) and t.device.type == "cuda" for t in inputs)
        if ok:
            index = self.device.index
            ok = all(t.device.index == (torch.cuda.current_device() if index is None else index)
                     for t in inputs)
        if not ok:
            raise ValueError(f"a graphed call on {self.device} copies its inputs into static "
                             "inputs there: pass tensors on that device, got " + ", ".join(
                                 str(t.device) if torch.is_tensor(t) else type(t).__name__
                                 for t in inputs))
        key = (tuple((tuple(t.shape), t.dtype) for t in inputs), graph_context())
        with self._lock, torch.cuda.device(self.device):
            if key not in self.graphs:
                if self.pool is None:
                    self.pool, self.stream = torch.cuda.MemPool(), torch.cuda.Stream()
                static = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                               for t in inputs)
                self.graphs[key] = static, CapturedCall(
                    functools.partial(self.fn, *static), self.pool, self.stream)
            static, run = self.graphs[key]
            for dst, src in zip(static, inputs):
                dst.copy_(src)
            captured = run.graph is not None
            # the warm-up's output lies in the pool too, maybe in blocks that
            # an earlier graph of the pool reuses at every replay: copied out
            out = run()
            if run.graph is not None and not captured:
                self.captures += 1
            return out.clone() if torch.is_tensor(out) else tuple(t.clone() for t in out)

    def close(self) -> None:
        """Wait for the device, then drop every graph and its buffers."""
        with self._lock:
            for _, run in self.graphs.values():
                run.close()
            self.graphs.clear()


def _eval_forward(segmentor, image: torch.Tensor) -> torch.Tensor:
    """Softmax of the main head's agg map (head 0 of the dual decoders), from
    the eval forward, in float32 (float64 for a float64 model, as the JAX
    forward computes in the model's dtype); the segmentor's mode is put
    back."""
    was_training = segmentor.training
    segmentor.eval()
    try:
        _, agg_maps = adapt_segmentor_output(segmentor(image))
    finally:
        segmentor.train(was_training)
    agg = agg_maps[0]
    return torch.softmax(agg.to(torch.promote_types(agg.dtype, torch.float32)), dim=-1)


def make_eval_step(num_classes: int = 2):
    """Inference and one batch's metrics: eval_step(segmentor, batch) ->
    (softmax prediction (b,h,w,c), `eval_step_metrics` of the vessel
    channel against batch["mask_onehot"])."""
    ch = 1 if num_classes > 1 else 0

    @torch.inference_mode()
    def eval_step(segmentor, batch):
        pred = _eval_forward(segmentor, batch["image"])
        return pred, eval_step_metrics(pred[..., ch], batch["mask_onehot"][..., ch])

    return eval_step


def make_eval_accumulate_step(num_classes: int = 2, threshold: float = 0.5):
    """Streaming eval: eval_step(segmentor, batch) -> (softmax prediction,
    confusion counts, ROC histograms) of one batch, for dataset-level
    Dice/AUC. The segmentor runs its eval forward in float32; the dual
    decoders are scored on head 0 (the deep, full-vessel one); a per-sample
    `sample_weight` of 0 drops a padding sample from the counts."""

    @torch.inference_mode()
    def eval_step(segmentor, batch):
        pred = _eval_forward(segmentor, batch["image"])
        ch = 1 if num_classes > 1 else 0
        vessel_prob, target = pred[..., ch], batch["mask_onehot"][..., ch]
        weight = batch.get("sample_weight")
        conf = ConfusionAccumulator.empty(device=pred.device).update(
            (vessel_prob >= threshold).long(), target, weight)
        auc = AucAccumulator.empty(device=pred.device).update(vessel_prob, target, weight)
        return pred, conf, auc

    return eval_step


def eval_counts(eval_step, segmentor, image: torch.Tensor, mask_onehot: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One batch's confusion counts and ROC histograms from `eval_step` (of
    make_eval_accumulate_step), packed into one int64 vector: tp, fp, fn,
    tn, then the positive and the negative histogram (`unpack_counts`)."""
    _, conf, auc = eval_step(segmentor, {"image": image, "mask_onehot": mask_onehot,
                                         "sample_weight": sample_weight})
    return torch.cat([torch.stack(list(conf)), *auc])


def unpack_counts(packed) -> Tuple[ConfusionAccumulator, AucAccumulator]:
    """`eval_counts`'s vector (a tensor or a numpy array) as accumulators."""
    bins = (len(packed) - 4) // 2
    return (ConfusionAccumulator(*packed[:4]),
            AucAccumulator(packed[4:4 + bins], packed[4 + bins:]))
