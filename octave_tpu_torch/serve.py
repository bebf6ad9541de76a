"""Inference serving: the port of `octave_tpu/serve.py`.

`Predictor` (:26-318) runs the 304² ResnestUNet eval forward in bf16 with the
batch-norm stats folded into an affine and, by default, the fused decoder
epilogue kernel at every gated depth; optionally int8 or with grouped convs
lowered, and optionally fanned out over a mesh of devices (`mesh=`, a replica
of the model per device, each taking its rows of every batch). Requests
arrive as uint8 (B,H,W,3) and are normalised on the device; results leave as
float32 / float16 probabilities or a uint8 vessel mask.

`BatchServer` (:321-671) is the request front end: callers submit single
images, a worker thread groups them into (k, batch) stacks, and a resolver
thread hands the results back, so that the device runs one stack while the
next is assembled and the previous is downloaded.

Asynchrony is explicit on CUDA. Every dispatch runs over the replicas, one
per device of the mesh (without a mesh, the model itself on its one device).
A dispatch (`predict_many_device`) uploads each replica's rows with
non-blocking copies on that replica's upload stream (truly asynchronous when
the caller's array lies in pinned memory, as the server's staging buffers
do), enqueues the replica's forwards on its device's current stream after
the upload's event, records an event and returns a `DeviceResult` without
waiting. Converting that to numpy waits for each event on the replica's own
copy stream and downloads into pinned memory, so a download never queues
behind forwards that were enqueued after its own, and joins the shards in
row order. The device tensors stay referenced by the `DeviceResult` until
their downloads have finished, so the caching allocator cannot hand their
blocks to a later forward. A batch that is already a tensor on a CUDA device
is not uploaded: each replica takes its rows where they lie (in place on its
own device), as the JAX package's `predict_many_device` takes a device array.

On CUDA every dispatch is one replay of a captured CUDA graph per replica,
the counterpart of the JAX package's jax.jit(fwd) (octave_tpu/serve.py:
119-144) and of its k-batch program (:257-285): one graph per (k, batch,
image shape, wire dtype, `train.steps.graph_context()`) on each replica
(`train.steps.StaticGraphs`), its k forwards in order on one stream, so
that their activations reuse each other's memory. `__call__` is a stack of
k = 1. The first dispatch at a shape runs eagerly (it compiles the Triton
kernels, lets cuDNN pick its algorithms and fills the int8 convs' caches)
and the second captures; `warmup` does both for every k it is given. The
rows go into the graph's static input on the device's current stream after
the upload's event, and the output (the replay's, or the eager warm-up's)
is copied out of the graphs' pool there, so a `DeviceResult` holds memory
that no later replay touches, and the graphs of one replica share one
memory pool. `graphed=False` keeps every dispatch eager.
"""
from __future__ import annotations

import functools
import queue
import re
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from octave_tpu_torch.models.resnest import dense_groups_include, lower_grouped_convs_
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops import quant
from octave_tpu_torch.ops.norm import fold_batch_stats, folded_inference
from octave_tpu_torch.parallel.mesh import as_mesh, replicate, split_rows
from octave_tpu_torch.train.steps import GRAPH_WARMUP_CALLS, StaticGraphs
from octave_tpu_torch.utils import profiling
from octave_tpu_torch.utils.convert import load_reference_state_dict

OUTPUT_FORMATS = ("prob_f32", "prob_f16", "mask_u8")


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device(device); raises if it names CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device


# the convs each int8_scope quantises, by the port's scale keys (ops/quant.py)
# and as `octave_tpu/serve.py::Predictor._calibrate` selects them: the
# backbone is the stem (`encoder_0_1_2`) and `encoder_1..4`, and `dense`
# leaves out each Bottleneck's SplAt `conv2` subtree
_BACKBONE = re.compile(r"encoder_(0_1_2|[1-4])\.")
INT8_SCOPES = {
    "all": lambda k: True,
    "dense": lambda k: k.startswith("decoder_")
    or (_BACKBONE.match(k) is not None and ".conv2." not in k),
    "decoder+ups": lambda k: k.startswith(("decoder_", "upsampling_")),
    "decoder": lambda k: k.startswith("decoder_"),
}


class Predictor:
    """Batched OCTA vessel predictor around ResnestUNet.predict."""

    def __init__(
        self,
        state_dict: Mapping[str, Any],
        num_classes: int = 2,
        method: str = "softmax",
        dtype: torch.dtype = torch.bfloat16,
        use_fused_decoder: bool = True,
        fold_bn: bool = True,
        output_format: str = "prob_f32",
        device: str | torch.device | None = None,
        int8_decoder: bool = False,
        calibration_batches: Optional[Iterable[np.ndarray]] = None,
        int8_scope: str = "decoder",
        int8_prepack: bool = True,
        dense_groups: Optional[str] = None,
        einsum_groups: Optional[str] = None,
        mesh: Optional[Sequence[torch.device]] = None,
        graphed: Optional[bool] = None,
    ):
        """state_dict: reference-named weights with raw BN stats (e.g. from
        `utils.convert.from_jax_variables`). fold_bn folds the stats in
        float32 before the cast to `dtype`, as the JAX Predictor does.
        use_fused_decoder=False runs the AAG kernel after each plain decoder
        block instead of the fused decoder epilogue.

        int8_decoder: post-training int8 quantisation (ops/quant.py) of the
        convs `int8_scope` selects ('decoder' | 'decoder+ups' | 'dense' |
        'all', see INT8_SCOPES), with static activation scales from running
        `calibration_batches` (input batches as `__call__` takes them) through
        this predictor's folded, cast eval graph; the weights are quantised
        from the folded, cast ones, once (`int8_prepack`) or on every call.

        dense_groups / einsum_groups lower the grouped convs a spec selects
        ('decoder' | 'decoder:<digits>' | 'enc' | 'all' | '+'-combos, as the
        JAX Predictor takes them; `models.resnest.lower_grouped_convs_`) to
        block-diagonal dense convs / to shifted batched matmuls; exact math,
        with the fused epilogue or the AAG kernel, folded BN or not. A conv
        that int8 quantises runs as the int8 path runs every grouped conv,
        one block-diagonal GEMM (`ops/quant.py`): what the JAX package's
        dense lowering composed with int8 computes, so no second lowering
        applies there.

        device: CUDA by default, or the mesh's first device. mesh: a sequence
        of devices (`parallel.mesh.make_mesh()` for every visible GPU; one
        device may repeat, e.g. (cuda:0, cuda:0)). The model is built, folded,
        lowered, calibrated and quantised once on mesh[0] and then copied to
        every device of the mesh (`parallel.mesh.replicate`; the int8 scales
        are shared, the prepacked int8 weights are buffers and move with
        their replica). Every call splits the batch rows evenly over the
        replicas (a ValueError unless the mesh size divides them) and returns
        the rows in order.

        graphed: whether each dispatch runs as a CUDA-graph replay on every
        replica (see the module docstring); None captures on CUDA, False
        keeps every dispatch eager, True raises a ValueError off CUDA. The
        process-wide switches a forward reads (`train.steps.graph_context`:
        the ConvTranspose lowering, TF32, deterministic algorithms) are part
        of a graph's key, so changing one captures anew. Each replica's
        graphs keep one memory pool, which holds their activations for as
        long as the Predictor lives: two graphed Predictors in one process
        hold two pools, where eager ones share the general cache."""
        # cheap argument checks first, before any model build or BN fold
        for spec in (dense_groups, einsum_groups):
            if spec is not None:
                dense_groups_include(spec)
        if int8_decoder and calibration_batches is None:
            raise ValueError("int8_decoder=True requires calibration_batches "
                             "(a few representative input batches)")
        if int8_decoder and int8_scope not in INT8_SCOPES:
            raise ValueError(f"unknown int8_scope {int8_scope!r}; expected one of "
                             f"{sorted(INT8_SCOPES)}")
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"output_format must be one of {OUTPUT_FORMATS}; "
                             f"got {output_format!r}")
        if mesh is not None:
            mesh = as_mesh(mesh)
            if device is not None and not _same_device(torch.device(device), mesh[0]):
                raise ValueError(f"device={device} but the mesh's first device is {mesh[0]}")
            device = mesh[0]
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = (self.device,) if mesh is None else mesh
        if graphed and self.device.type != "cuda":
            raise ValueError(f"graphed=True needs CUDA: CUDA graphs cannot run on {self.device}")
        self.graphed = self.device.type == "cuda" if graphed is None else bool(graphed)
        self.method = method
        self.dtype = dtype
        self.output_format = output_format
        # the stack forward in this Predictor's settings; it holds no
        # reference to the Predictor, whose replicas' graphs keep it
        self._run = functools.partial(_stack_forward, dtype=dtype, method=method,
                                      output_format=output_format)
        with profiling.phase("octave.predictor.build"):
            if fold_bn:
                state_dict = fold_batch_stats(
                    {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                     for k, v in state_dict.items()})
            model = ResnestUNet(num_classes, use_fused_decoder=use_fused_decoder)
            load_reference_state_dict(model, state_dict)
            folded_inference(model, fold_bn)
            lower_grouped_convs_(model, dense_groups, einsum_groups)
            self.model = model.to(self.device, dtype).to(
                memory_format=torch.channels_last).eval()
        # the first replica is the model itself; calibration runs through it alone
        self.replicas: Tuple[_Replica, ...] = (_Replica(self.model, self.device),)
        self.int8_scales: Optional[Dict[str, float]] = None
        if int8_decoder:
            # eager, with its hooks: the replicas have no graphs yet
            with profiling.phase("octave.quant.calibrate"), torch.inference_mode():
                stats = quant.calibrate(self.model, calibration_batches, lambda batch:
                                        self._dispatch(_stacked(batch)))
            with profiling.phase("octave.quant.quantize"):
                self.int8_scales = quant.scales_from_stats(stats, INT8_SCOPES[int8_scope])
                quant.quantize_(self.model, self.int8_scales, prepack=int8_prepack)
        if len(self.mesh) > 1:
            self.replicas += tuple(_Replica(m, d) for m, d in
                                   zip(replicate(self.model, self.mesh[1:]), self.mesh[1:]))
        if self.graphed:
            for rep in self.replicas:
                rep.graphs = StaticGraphs(functools.partial(self._run, rep.model), rep.device)

    @property
    def captures(self) -> int:
        """The graphs captured so far, over every replica."""
        return sum(rep.graphs.captures for rep in self.replicas if rep.graphs is not None)

    @classmethod
    def initialize(cls, image_hw: Tuple[int, int] = (304, 304), seed: int = 0, **kw):
        """A predictor on fresh random weights (torch's initialisers from
        `seed`); weights usually come from a checkpoint or an exported npz.
        `image_hw` is accepted for the JAX signature: the modules need no
        input shape to be built."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = ResnestUNet(kw.get("num_classes", 2))
        return cls(model.state_dict(), **kw)

    def host_buffer(self, shape: Sequence[int], dtype) -> np.ndarray:
        """An uninitialised host array for requests: in pinned memory when the
        predictor is on CUDA, so that its upload does not block the host."""
        dtype = np.dtype(dtype)
        raw = torch.empty(int(np.prod(shape)) * dtype.itemsize, dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        return raw.numpy().view(dtype).reshape(tuple(shape))

    def _dispatch(self, stack) -> "DeviceResult":
        """The forwards of a (k, B, ...) stack (a numpy array or a tensor) on
        every replica for its rows along the batch axis; the shards in row
        order. A host stack goes up on each replica's upload stream and its
        forwards run on the device's current stream, after the upload's
        event: a replay of the replica's graph of this shape, or eagerly. A
        stack already on a CUDA device stays there: each replica takes its
        rows in place on its own device, or as a device-to-device copy."""
        with profiling.span("octave.predictor.dispatch"):
            parts = []
            if not torch.is_tensor(stack):
                stack = torch.from_numpy(np.ascontiguousarray(stack))  # no copy if contiguous
            elif stack.device.type == "cpu":
                stack = stack.contiguous()
            for rep, t in zip(self.replicas, split_rows(stack, len(self.replicas), 1)):
                # uint8 stays uint8 on the wire; floats go up in the compute dtype
                # (a device tensor is cast on its device)
                if t.dtype != torch.uint8:
                    t = t.to(self.dtype)
                if rep.device.type != "cuda":
                    parts.append((self._run(rep.model, t.to(rep.device)), None, None))
                    continue
                with torch.cuda.device(rep.device):
                    if t.device.type == "cuda":
                        x = t.to(rep.device, non_blocking=True)  # no copy on its own device
                    else:
                        x = rep.put(t)
                    out = rep.graphs(x) if rep.graphs is not None else self._run(rep.model, x)
                    compute = torch.cuda.current_stream(rep.device)
                    done = torch.cuda.Event()
                    done.record(compute)
                parts.append((out, done, rep.download))
            return DeviceResult(parts, 1)

    @torch.inference_mode()
    def __call__(self, batch) -> np.ndarray:
        """(B,H,W,3) uint8 or float in [0,1] -> (B,H,W,K) probabilities, or
        a (B,H,W) uint8 mask for output_format='mask_u8'. `batch` is a numpy
        array or a tensor; one already on a CUDA device is not copied to
        the host (`_dispatch`). A stack of one batch."""
        return np.asarray(self._dispatch(_stacked(batch)))[0]

    def predict_many(self, stack) -> np.ndarray:
        """A (k,B,H,W,3) stack of batches: one upload, k forwards in order,
        one download."""
        return np.asarray(self.predict_many_device(stack))

    @torch.inference_mode()
    def predict_many_device(self, stack) -> "DeviceResult":
        """predict_many without the download: enqueues the upload and the k
        forwards and returns at once; a stack already on the device (a
        tensor, as the JAX package's `predict_many_device` takes a device
        array) is used where it lies. `.tensor` is the (k, B, ...) device
        tensor, for work that stays on the device; `np.asarray(result)` waits
        and downloads. The k forwards run in order on one stream (one graph
        replay on CUDA), so their activations reuse each other's memory.
        With a mesh, axis 1 (the batch) is split over the replicas."""
        return self._dispatch(stack)

    def warmup(self, batch: int, image_hw: Tuple[int, int], ks: Sequence[int] = (1,),
               in_channels: int = 3, wire_dtype=np.uint8) -> None:
        """Prepare (batch, image_hw, wire_dtype) so that no request meets a
        compilation, cuDNN's algorithm choice or a capture. On CUDA each k in
        `ks` is its own graph: each is run eagerly and then captured, as the
        JAX package compiles each aggregation depth (octave_tpu/serve.py:
        287-297). Eagerly one forward does (the kernels and algorithms
        depend on the batch's shape and dtype, not on k)."""
        ks, calls = (tuple(ks), GRAPH_WARMUP_CALLS + 1) if self.graphed else ((1,), 1)
        for k in ks:
            for _ in range(calls):
                np.asarray(self.predict_many_device(
                    np.zeros((k, batch, *image_hw, in_channels), wire_dtype)))

    def predict_stream(self, batches: Iterable[np.ndarray],
                       depth: int = 2) -> Iterator[np.ndarray]:
        """Pipelined prediction over a stream of batches: up to `depth`
        dispatches are in flight, so the device runs batch i while the host
        prepares and uploads batch i+1."""
        inflight: deque = deque()
        for batch in batches:
            # drain before dispatching, so at most `depth` are ever in flight
            if len(inflight) >= depth:
                yield np.asarray(inflight.popleft())[0]
            inflight.append(self.predict_many_device(batch[None]))  # a stack of one
        while inflight:
            yield np.asarray(inflight.popleft())[0]


def _forward(model: torch.nn.Module, batch: torch.Tensor, dtype: torch.dtype, method: str,
             output_format: str) -> torch.Tensor:
    """Device forward of one (B,H,W,3) batch already on the device, by
    `model` (a replica's)."""
    if batch.dtype == torch.uint8:
        batch = batch.to(dtype) / 255.0  # uint8 wire format, normalised here
    _, pred = model.predict(batch, method)
    if output_format == "mask_u8":
        vessel = pred[..., 1] if pred.shape[-1] > 1 else pred[..., 0]
        return (vessel >= 0.5).to(torch.uint8) * 255
    if output_format == "prob_f16":
        return pred.to(torch.float16)
    return pred.to(torch.float32)


def _stack_forward(model: torch.nn.Module, stack: torch.Tensor, **kw) -> torch.Tensor:
    """The forwards (`_forward`) of a (k, B, H, W, C) stack on the device,
    in order on one stream (their activations reuse each other's memory)."""
    if stack.shape[0] == 1:
        return _forward(model, stack[0], **kw).unsqueeze(0)
    return torch.stack([_forward(model, x, **kw) for x in stack])


def _stacked(batch):
    """A (B, ...) batch, numpy or tensor, as a stack of one (1, B, ...)."""
    return (batch if torch.is_tensor(batch) else np.asarray(batch))[None]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device (cuda = cuda:<current device>)."""
    if a.type == b.type == "cuda" and a.index is None:
        a = torch.device("cuda", torch.cuda.current_device())
    return a == b


class _Replica:
    """A mesh device's copy of the model, with its upload and download
    streams on CUDA and, when the Predictor is graphed, its graphs."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model, self.device = model, device
        cuda = device.type == "cuda"
        self.upload = torch.cuda.Stream(device) if cuda else None
        self.download = torch.cuda.Stream(device) if cuda else None
        self.graphs: Optional[StaticGraphs] = None

    def put(self, host: torch.Tensor) -> torch.Tensor:
        """`host` copied to this replica's CUDA device on its upload stream,
        for a forward on the device's current stream (which waits for the
        copy's event)."""
        with torch.cuda.stream(self.upload):
            x = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            # a shard of a (k, B, ...) stack split along the batch is k runs
            # of memory: one copy each keeps a pinned stack's upload
            # asynchronous, where a contiguous host copy of the shard would be
            # pageable and block the host
            for dst, src in ([(x, host)] if host.is_contiguous() else zip(x, host)):
                dst.copy_(src, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record()
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(uploaded)
        x.record_stream(compute)  # allocated on the upload stream, read on compute
        return x


class DeviceResult:
    """The output of a dispatch, still on the device and possibly still being
    computed. `np.asarray(result)` waits for it and returns it as a host
    array (backed by pinned memory on CUDA). The output of a fanned-out
    dispatch has one part per replica: `np.asarray` downloads each on its
    replica's copy stream and joins them along the split axis."""

    def __init__(self, parts: Sequence[tuple], axis: int):
        """parts: one (device tensor, done event or None, copy stream or
        None) per replica, in row order along `axis`."""
        self._parts, self._axis = list(parts), axis

    @property
    def tensor(self) -> torch.Tensor:
        """The device tensor; the shards of a fanned-out dispatch joined on
        the first shard's device."""
        if len(self._parts) == 1:
            return self._parts[0][0]
        first = self._parts[0][0].device
        return torch.cat([t.to(first) for t, _, _ in self._parts], dim=self._axis)

    @staticmethod
    def _download(out, done, copy_stream):
        """(host tensor, event of its copy or None): the download enqueued on
        `copy_stream` after `done`, into pinned memory."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(done)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        return host, copied

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        # every shard's download is enqueued before the first wait; each
        # device tensor is referenced until its copy has finished
        with profiling.span("octave.predictor.result"):
            pending = [self._download(*part) for part in self._parts]
            with profiling.span("octave.predictor.wait"):
                for _, copied in pending:
                    if copied is not None:
                        copied.synchronize()
            arrs = [host.numpy() for host, _ in pending]
            arr = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=self._axis)
            return arr if dtype is None else arr.astype(dtype)


class BatchServer:
    """Queue-depth-adaptive dynamic batcher over a `Predictor`.

    Callers `submit()` single images (h, w, c) and get a
    `concurrent.futures.Future` for the per-image output. A worker thread
    groups pending requests into (k, batch, h, w, c) stacks for
    `Predictor.predict_many_device` and picks the aggregation depth k PER
    DISPATCH from the queue backlog:

      * idle or low load -> k = 1, a partial batch zero-padded: lowest latency;
      * backlog          -> the largest k in `ks` the backlog fills: one
        upload, one download and one hand-over per k batches.

    Shapes are static: every request must be exactly `image_hw` + `channels`
    in `wire_dtype` (resize upstream), and every dispatch uses the batch
    shape that `warmup` ran at every k of `ks`, so serving never compiles a
    kernel, picks a cuDNN algorithm or (on CUDA) captures a graph again: the
    worker only replays. Without the warm-up the worker captures where it
    first meets a k, while the resolver thread downloads (the captures
    allow other threads' device work). Zero-padded slots ride along and are
    dropped on the way out: at k = 1 a single request costs one full batch of device
    time, the price of static shapes; pick `batch` for the latency target and
    let k scale throughput.

    Dispatch is pipelined: the worker stacks requests into a pinned staging
    buffer and dispatches chunk i+1 (upload and forwards are only enqueued)
    while the resolver thread waits for chunk i's download and resolves its
    futures. `pipeline_depth` bounds the dispatched-but-unresolved chunks.
    A staging buffer goes back to the free pool only when its chunk has been
    resolved, so it is never refilled while its upload is pending; the pool
    holds pipeline_depth + 2 buffers (the chunks in the result queue, the one
    the resolver holds and the one being assembled).

    Two layers of memory protection. Forwards enqueued on one stream reuse
    each other's activation memory, but every dispatched chunk holds its own
    input and output stacks on the device until it is resolved:
    `max_inflight_images` caps the images dispatched and unresolved at once.
    If the device still runs out (`torch.OutOfMemoryError`, raised in the
    dispatching thread at the allocation), the server permanently drops the
    aggregation depths from the failing one up and re-runs the chunk at a
    smaller k: serving degrades instead of dying.

    `stats()` is the operator's reading of a live server: requests, the
    k x batch slots and the dispatches of its worker, the fill and the mean
    wait from `submit` to the dispatch. Each dispatch of the worker is the
    span `octave.batch_server.dispatch` in a profile of the worker's thread.

    `predictor` needs `warmup`, `predict_many_device` and `host_buffer`.
    """

    def __init__(
        self,
        predictor: Any,
        batch: int = 16,
        image_hw: Tuple[int, int] = (304, 304),
        channels: int = 3,
        ks: Sequence[int] = (1, 2, 4),
        wire_dtype=np.uint8,
        warmup: bool = True,
        max_queue: int = 4096,
        pipeline_depth: int = 2,
        max_inflight_images: int = 256,
    ):
        self.predictor = predictor
        self.batch = int(batch)
        self.image_hw = tuple(image_hw)
        self.channels = int(channels)
        self.ks = tuple(sorted(set(int(k) for k in ks)))
        if not self.ks or self.ks[0] < 1:
            raise ValueError(f"ks must be positive ints, got {ks!r}")
        self.wire_dtype = np.dtype(wire_dtype)
        self._shape = (*self.image_hw, self.channels)
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        # The budget has two consequences:
        #   1. admission: the worker blocks until the dispatched images plus
        #      k*batch fit max_inflight_images (a lone chunk always passes);
        #   2. k capping: depths whose stacks cannot run TWO abreast within
        #      the budget are dropped upfront, since a k that forfeits the
        #      overlap of dispatch and download is not worth dispatching.
        self.max_inflight_images = int(max_inflight_images)
        if self.max_inflight_images < 1:
            raise ValueError(f"max_inflight_images must be >= 1, got {max_inflight_images}")
        self.ks_requested = self.ks
        usable = tuple(k for k in self.ks if 2 * k * self.batch <= self.max_inflight_images)
        self.ks = usable or (self.ks[0],)
        self._ks_live = self.ks  # shrinks further on device OOM (_shrink_ks)
        self._inflight_images = 0
        self._inflight_cv = threading.Condition()
        self._stats = dict.fromkeys(("requests", "slots", "dispatches", "queue_wait_s"), 0)
        self._stats_lock = threading.Lock()
        if warmup:
            predictor.warmup(self.batch, self.image_hw, self.ks, self.channels, self.wire_dtype)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        # dispatched-but-unresolved chunks; bounded, so a slow download holds
        # the worker back instead of piling up device buffers
        self._results: "queue.Queue" = queue.Queue(maxsize=self.pipeline_depth)
        self._staging: "queue.Queue" = queue.Queue()
        for _ in range(self.pipeline_depth + 2):
            self._staging.put(predictor.host_buffer(
                (self.ks[-1], self.batch, *self._shape), self.wire_dtype))
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="octave-batch-server")
        self._resolver = threading.Thread(target=self._resolve, daemon=True,
                                          name="octave-batch-resolver")
        self._worker.start()
        self._resolver.start()

    # -- client side ----------------------------------------------------
    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (h, w, c) image; returns a Future of the (h, w, ...)
        output (the predictor's output_format decides the payload)."""
        if self._closed:
            raise RuntimeError("BatchServer is closed")
        img = np.asarray(image)
        if img.shape != self._shape:
            raise ValueError(f"request shape {img.shape} != served shape {self._shape} "
                             "(resize upstream; serving shapes are static)")
        if img.dtype != self.wire_dtype:
            raise ValueError(f"request dtype {img.dtype} != wire dtype {self.wire_dtype} "
                             "(the dtype is part of the warmed-up signature)")
        fut: Future = Future()
        self._queue.put((img, fut, time.perf_counter()))
        return fut

    def map(self, images: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Submit a stream and yield results in order (keeps enough requests
        pending to fill every pipeline slot's max-k stack, plus one being
        assembled)."""
        pending: "deque[Future]" = deque()
        depth = self.ks[-1] * self.batch * (self.pipeline_depth + 2)
        for img in images:
            while len(pending) >= depth:
                yield pending.popleft().result()
            pending.append(self.submit(img))
        while pending:
            yield pending.popleft().result()

    def stats(self) -> Dict[str, float]:
        """This server's dispatches so far, as its worker counts them (an
        OOM's synchronous re-run in the resolver is not counted again):
        `requests` dispatched, `slots` (k x batch of each dispatch),
        `dispatches`, `queue_wait_s` (the summed waits from `submit` to the
        dispatch), `fill` (requests / slots) and `mean_wait_s` (queue_wait_s
        / requests). The process-wide sums are `utils.profiling.counters()`'
        `batch_server.*`."""
        with self._stats_lock:
            out = dict(self._stats)
        out["fill"] = out["requests"] / out["slots"] if out["slots"] else 0.0
        out["mean_wait_s"] = out["queue_wait_s"] / out["requests"] if out["requests"] else 0.0
        return out

    def _tally(self, **counts) -> None:
        with self._stats_lock:
            for name, n in counts.items():
                self._stats[name] += n
                profiling.count(f"batch_server.{name}", n)

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker and the resolver."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)  # sentinel
        self._worker.join()  # the worker forwards the sentinel to the resolver
        self._resolver.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ----------------------------------------------------
    def _take(self):
        """Block for the first request, then greedily drain up to
        max_k*batch more without blocking. Returns (items, stop)."""
        first = self._queue.get()
        if first is None:
            return [], True
        items = [first]
        cap = self.ks[-1] * self.batch
        stop = False
        while len(items) < cap:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                stop = True
                break
            items.append(nxt)
        return items, stop

    def _pick_k(self, n: int) -> int:
        """Largest LIVE k whose stack the backlog fills at least (k-1)
        batches of: grow k only when there is work to amortise over.
        `_ks_live` starts as `ks` and shrinks permanently when a depth runs
        the device out of memory."""
        k = self._ks_live[0]
        for cand in self._ks_live:
            if n > (cand - 1) * self.batch:
                k = cand
        return k

    @staticmethod
    def _is_oom(e: BaseException) -> bool:
        """Device out-of-memory: raised at the allocation, in the thread that
        dispatches (or, for the download's host buffer, resolves)."""
        return isinstance(e, torch.OutOfMemoryError)

    def _shrink_ks(self, failed_k: int) -> bool:
        """Permanently drop every aggregation depth >= failed_k. Returns
        False if nothing smaller is left (the smallest k also fails:
        unrecoverable)."""
        live = [k for k in self._ks_live if k < failed_k]
        if not live:
            return False
        self._ks_live = tuple(live)
        return True

    def _stack(self, chunk, k: int):
        """(staging buffer, its first k batches filled with the chunk and
        zero-padded). Blocks until a staging buffer is free."""
        buf = self._staging.get()
        stack = buf[:k]
        flat = stack.reshape(k * self.batch, *self._shape)
        for i, (img, _, _) in enumerate(chunk):
            flat[i] = img
        flat[len(chunk):] = 0
        return buf, stack

    def _dispatch_retrying(self, stack: np.ndarray):
        """Dispatch a stack; on an OOM, back off once and retry at the SAME k
        before letting the caller shrink: an allocation failure at enqueue
        time is often pressure from the other chunks in flight, not proof
        that k is too big."""
        try:
            return self.predictor.predict_many_device(stack)
        except Exception as e:
            if not self._is_oom(e):
                raise
            time.sleep(1.0)  # let the chunks in flight resolve and free their stacks
            return self.predictor.predict_many_device(stack)

    def _run(self) -> None:
        while True:
            items, stop = self._take()
            while items:
                k = self._pick_k(len(items))
                take = min(len(items), k * self.batch)
                chunk, items = items[:take], items[take:]
                # block until the budget admits this chunk (a lone one always
                # passes); the resolver releases as chunks complete
                with self._inflight_cv:
                    while (self._inflight_images > 0 and self._inflight_images
                           + k * self.batch > self.max_inflight_images):
                        self._inflight_cv.wait()
                    self._inflight_images += k * self.batch
                buf, stack = self._stack(chunk, k)
                now = time.perf_counter()
                try:
                    # returns once the upload and the forwards are ENQUEUED;
                    # the resolver waits for the result while this thread
                    # stacks and dispatches the next chunk
                    with profiling.span("octave.batch_server.dispatch", k=k,
                                        requests=len(chunk)):
                        out = self._dispatch_retrying(stack)
                except Exception as e:
                    self._staging.put(buf)
                    self._release_inflight(k)
                    if self._is_oom(e) and self._shrink_ks(k):
                        # re-chunk at the shrunk depths through the normal
                        # pipelined path
                        items = chunk + items
                    else:
                        self._fail(chunk, e)
                    continue
                self._tally(requests=len(chunk), slots=k * self.batch, dispatches=1,
                            queue_wait_s=sum(now - t for _, _, t in chunk))
                self._results.put((chunk, k, out, buf))  # blocks at pipeline_depth
            if stop:
                self._results.put(None)
                # resolve anything enqueued after the sentinel raced in
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if nxt is not None:
                        nxt[1].set_exception(RuntimeError("BatchServer closed"))

    @staticmethod
    def _deliver(chunk, out) -> None:
        """Resolve a chunk's futures from its (k, batch, ...) output."""
        arr = np.asarray(out)  # waits for the forwards and the download
        arr = arr.reshape(arr.shape[0] * arr.shape[1], *arr.shape[2:])
        for i, (_, fut, _) in enumerate(chunk):
            fut.set_result(arr[i])

    @staticmethod
    def _fail(chunk, e: BaseException) -> None:
        """Surface a failure on every waiter of a chunk."""
        for _, fut, _ in chunk:
            if not fut.done():
                fut.set_exception(e)

    def _release_inflight(self, k: int) -> None:
        with self._inflight_cv:
            self._inflight_images -= k * self.batch
            self._inflight_cv.notify_all()

    def _resolve(self) -> None:
        """Wait for each dispatched chunk's download and resolve its
        futures, in dispatch order."""
        while True:
            item = self._results.get()
            if item is None:
                return
            chunk, k, out, buf = item
            try:
                arr = np.asarray(out)  # waits for the forwards and the download
            except Exception as e:
                self._staging.put(buf)
                self._release_inflight(k)
                # A chunk can also fail here (the download's host buffer, or
                # a predictor that reports failures at consumption). Shrink
                # the live depths, then re-run THIS chunk synchronously at
                # the smallest k, right here: the resolver must never block
                # on _results.put (it is its own consumer) or _queue.put
                # (deadlocks against a full client queue while the worker
                # waits on _results).
                if self._is_oom(e) and self._shrink_ks(k):
                    self._resolve_fallback(chunk)
                else:
                    self._fail(chunk, e)
                continue
            self._staging.put(buf)
            self._release_inflight(k)
            self._deliver(chunk, arr)

    def _resolve_fallback(self, chunk) -> None:
        """Re-run an OOM-failed chunk at the smallest live k, synchronously
        (dispatching from this thread beside the worker is safe: both
        enqueue on one stream). Chunks dispatched at the old k may still
        fail the same way and land back here; `_ks_live` shrinks
        monotonically, so this terminates. Each piece retries with backoff:
        right after an OOM the other chunks in flight still hold their
        stacks."""
        kmin = self._ks_live[0]
        size = kmin * self.batch
        for lo in range(0, len(chunk), size):
            piece = chunk[lo:lo + size]
            for attempt in range(6):
                buf, stack = self._stack(piece, kmin)
                try:
                    self._deliver(piece, self.predictor.predict_many_device(stack))
                    break
                except Exception as e:
                    if self._is_oom(e) and attempt < 5:
                        time.sleep(0.5 * (2 ** attempt))  # let the device drain
                        continue
                    self._fail(piece, e)
                    break
                finally:
                    self._staging.put(buf)
