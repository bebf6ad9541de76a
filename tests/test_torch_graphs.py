"""The compiled serving and eval programs, as far as a host without CUDA can
hold them, against the JAX package on the CPU:

  * the ROC histogram's fixed-length accumulation (`AucAccumulator.update`:
    `index_add_` into 2 * bins + 1 counts, where a bincount's length would
    need a host sync that a CUDA-graph capture refuses) against the bincount
    form it replaced and against the JAX package's accumulator, exactly:
    scores at 0, at 1, on bin edges and just below them, zero-weight padding
    samples, float32 and bfloat16 scores;
  * `make_eval_accumulate_step` against the JAX package's on the golden fill
    of unet112 at 64², in float64 (in float32 the two forwards differ by
    ~1e-6, and some of 12,288 pixels would land in a neighbouring bin of
    width 2^-12), counts exact; its packed form (`eval_counts`, what
    `Trainer.evaluate` captures on CUDA) against the accumulators, and a CPU
    `Trainer.evaluate`, eager, against the counts summed batch by batch;
  * the `graphed` argument: `Predictor(graphed=True)` off CUDA raises;
    `graphed=None` on the CPU runs eagerly and equals the JAX Predictor to
    1e-4, as tests/test_torch_unet.py holds it;
  * `StaticGraphs`'s input contract: off CUDA, or given inputs that are not
    tensors on its device, it raises before it touches a device;
  * `graph_context`, part of every graph's key: each process-wide switch
    that a captured forward reads changes it, and putting the switch back
    restores it.

What a capture does shows only on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 14).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import fill_state_dict, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models.segmentor import ResnestUNet as JaxUNet
from octave_tpu.serve import Predictor as JaxPredictor
from octave_tpu.train.steps import make_eval_accumulate_step as jax_make_eval_accumulate_step
from octave_tpu.utils import metrics as jmetrics
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.data import datasets as ds
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops import common
from octave_tpu_torch.serve import Predictor
from octave_tpu_torch.train.steps import (
    StaticGraphs,
    eval_counts,
    graph_context,
    make_eval_accumulate_step,
    unpack_counts,
)
from octave_tpu_torch.train.trainer import Trainer, build_dataset
from octave_tpu_torch.utils import metrics as tmetrics
from octave_tpu_torch.utils.config import Config
from octave_tpu_torch.utils.convert import from_jax_variables, load_reference_state_dict

BINS = 4096


@pytest.fixture(scope="module")
def golden():
    """The golden fill of unet112: (JAX variables as numpy, the port's state dict)."""
    manifest, _, _ = load_fixture("unet112")
    variables = jax.tree.map(np.asarray, convert_resnest_unet(fill_state_dict(manifest)))
    return variables, from_jax_variables(variables)


# -- the ROC histogram ----------------------------------------------------------
def _scores(seed):
    """(3, 16, 16) scores: uniform draws, then exact 0s and 1s, bin edges
    k / BINS, the float32 just below an edge, and a few outside [0, 1]."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, 3 * 16 * 16).astype(np.float32)
    edges = rng.integers(1, BINS, 120) / BINS
    s[:40] = 0.0
    s[40:80] = 1.0
    s[80:200] = edges
    s[200:260] = np.nextafter(edges[:60].astype(np.float32), np.float32(0))
    s[260:270] = [-0.25, 1.25, -1e-7, 1 + 1e-6, 2.0, -3.0, 0.5, 0.25, 0.75, 1 - 2**-24]
    return rng.permutation(s).reshape(3, 16, 16)


def _bincount_form(scores, target, weight):
    """The accumulator's update as it was: one torch.bincount, its length
    taken from the largest key."""
    s = scores.reshape(-1).float().clamp(0.0, 1.0)
    t = target.reshape(-1).long()
    key = (s * BINS).long().clamp(0, BINS - 1) + BINS * t
    if weight is not None:
        keep = torch.broadcast_to(weight.round().long().reshape(-1, 1, 1), scores.shape)
        key = torch.where(keep.reshape(-1) > 0, key, 2 * BINS)
    counts = torch.bincount(key, minlength=2 * BINS + 1)
    return counts[BINS:2 * BINS].numpy(), counts[:BINS].numpy()


@pytest.mark.parametrize("weighted", [False, True], ids=["all", "padding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_auc_histogram_equals_bincount_form_and_jax(seed, dtype, weighted):
    scores = _scores(seed)
    target = (np.random.default_rng(seed + 10).uniform(size=scores.shape) > 0.7)
    target = target.astype(np.float32)
    weight = np.array([1, 0, 1], np.float32) if weighted else None
    t_scores = torch.from_numpy(scores).to(getattr(torch, dtype))
    t_weight = None if weight is None else torch.from_numpy(weight)
    got = tmetrics.AucAccumulator.empty(device="cpu").update(
        t_scores, torch.from_numpy(target), t_weight).astype64()
    want = _bincount_form(t_scores, torch.from_numpy(target), t_weight)
    j = jmetrics.AucAccumulator.empty().update(
        jnp.asarray(scores).astype(getattr(jnp, dtype)), jnp.asarray(target),
        None if weight is None else jnp.asarray(weight)).astype64()
    kept = 2 if weighted else 3
    for g, w, jx in zip(got, want, j):
        assert g.dtype == np.int64 and g.shape == (BINS,)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jx)
    assert int(got.pos_hist.sum() + got.neg_hist.sum()) == kept * 16 * 16
    assert int(got.neg_hist[0]) >= 1 and int(got.pos_hist[-1] + got.neg_hist[-1]) >= 1


# -- the eval step ----------------------------------------------------------------
def test_eval_accumulate_step_matches_jax_exactly(golden):
    """float64, 64², B = 3 (the third sample a zero-weight pad): confusion
    counts and ROC histograms equal the JAX step's integer for integer; the
    packed vector the Trainer captures holds the same counts."""
    variables, sd = golden
    rng = np.random.default_rng(21)
    image = rng.uniform(0, 1, (3, 64, 64, 3))
    mask = (rng.uniform(size=(3, 64, 64)) > 0.6).astype(np.float64)
    onehot = np.stack([1 - mask, mask], -1)
    weight = np.array([1.0, 1.0, 0.0])
    with jax.enable_x64():
        f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
        v = f64(variables)
        _, jc, ja = jax.jit(jax_make_eval_accumulate_step(JaxUNet(num_classes=2)))(
            v["params"], v["batch_stats"],
            f64({"image": image, "mask_onehot": onehot, "sample_weight": weight}))
        jc, ja = [int(x) for x in jc], [np.asarray(x).astype(np.int64) for x in ja]
    seg = ResnestUNet(2)
    load_reference_state_dict(seg, sd)
    seg = seg.double().to(memory_format=torch.channels_last).train()
    step = make_eval_accumulate_step(2)
    inputs = [torch.from_numpy(a) for a in (image, onehot, weight)]
    _, tc, ta = step(seg, dict(zip(("image", "mask_onehot", "sample_weight"), inputs)))
    assert seg.training
    assert [int(x) for x in tc.astype64()] == jc and sum(jc) == 2 * 64 * 64
    for got, want in zip(ta.astype64(), ja):
        np.testing.assert_array_equal(got, want)
    packed = eval_counts(step, seg, *inputs)
    assert packed.dtype == torch.int64 and packed.shape == (4 + 2 * BINS,)
    pc, pa = unpack_counts(packed.numpy())
    assert [int(x) for x in pc] == jc
    for got, want in zip(pa, ja):
        np.testing.assert_array_equal(got, want)


def test_cpu_evaluate_is_eager_and_sums_exact_counts():
    """A CPU Trainer scores every batch eagerly (no graphs on the state); its
    dataset metrics equal the counts of `make_eval_accumulate_step` summed
    batch by batch over the test split (5 phantoms in batches of 2: a
    ragged last batch of 1)."""
    cfg = Config().apply_overrides({"data.image_size": "[32,32]", "data.synthetic_n": "5",
                                    "data.batch_size": "2", "model.num_filters": "8"})
    trainer = Trainer(cfg, device="cpu")
    assert trainer.graphed_eval is False
    state = trainer.init_state()
    assert trainer.eval_call(state).func is eval_counts
    got = trainer.evaluate(state)
    assert state.eval_graphs is None
    conf, auc = tmetrics.ConfusionAccumulator.empty_host(), tmetrics.AucAccumulator.empty_host()
    sizes = []
    for host in ds.batch_iterator(build_dataset(cfg, "test"), 2, shuffle=False, epochs=1,
                                  drop_last=False):
        sizes.append(host["image"].shape[0])
        _, c, a = trainer.eval_step(state.segmentor, trainer.device_batch(host))
        conf = tmetrics.ConfusionAccumulator(*(x + y for x, y in zip(conf, c.astype64())))
        auc = tmetrics.AucAccumulator(*(x + y for x, y in zip(auc, a.astype64())))
    assert sizes == [2, 2, 1]
    assert got == {"dice": float(conf.dice()), "iou": float(conf.iou()),
                   "accuracy": float(conf.accuracy()),
                   "sensitivity": float(conf.sensitivity()),
                   "specificity": float(conf.specificity()), "auc": float(auc.auc())}


# -- the graphed argument -----------------------------------------------------------
def test_graphed_predictor_needs_cuda(golden):
    _, sd = golden
    with pytest.raises(ValueError, match="graphed=True needs CUDA"):
        Predictor(sd, dtype=torch.float32, device="cpu", graphed=True)


def test_ungraphed_cpu_predictor_equals_jax(golden):
    """graphed=None on the CPU: eager, no graphs on any replica, and equal to
    the JAX Predictor (float32, folded BN, fused epilogue) through __call__
    and a k = 2 predict_many."""
    variables, sd = golden
    images = (np.random.default_rng(7).uniform(0, 1, (2, 2, 64, 64, 3)) * 255).astype(np.uint8)
    want = JaxPredictor(variables, dtype=jnp.float32, use_fused_decoder=True, fold_bn=True,
                        output_format="prob_f32")
    port = Predictor(sd, dtype=torch.float32, fold_bn=True, device="cpu")
    assert port.graphed is False and port.captures == 0
    assert all(rep.graphs is None for rep in port.replicas)
    many = port.predict_many(images)
    port.warmup(2, (64, 64), ks=(1, 2))
    for i in range(2):
        w = want(images[i])
        assert float(np.abs(port(images[i]) - w).max()) < 1e-4
        assert float(np.abs(many[i] - w).max()) < 1e-4
    assert port.captures == 0


@pytest.mark.parametrize("inputs", [
    lambda: (torch.zeros(2, 3),),
    lambda: (np.zeros((2, 3), np.float32),),
    lambda: (torch.zeros(2, 3), 1.0),
], ids=["cpu-tensor", "numpy", "scalar"])
def test_static_graphs_input_contract(inputs):
    """StaticGraphs copies its inputs into static inputs on its CUDA device:
    it refuses a CPU device, and inputs that are not tensors on its device,
    before it builds a stream, a pool or a graph."""
    with pytest.raises(ValueError, match="need a CUDA device"):
        StaticGraphs(lambda x: x, "cpu")
    graphs = StaticGraphs(lambda *xs: xs[0], "cuda:0")
    with pytest.raises(ValueError, match="pass tensors on that device"):
        graphs(*inputs())
    assert graphs.graphs == {} and graphs.pool is None and graphs.captures == 0


# each switch a graph would freeze: (read it, set it)
GRAPH_SWITCHES = {
    "conv_transpose_impl": (common.conv_transpose_impl, common.set_conv_transpose_impl,
                            ("native", "einsum")),
    "matmul_tf32": (lambda: torch.backends.cuda.matmul.allow_tf32,
                    lambda v: setattr(torch.backends.cuda.matmul, "allow_tf32", v),
                    (False, True)),
    "cudnn_tf32": (lambda: torch.backends.cudnn.allow_tf32,
                   lambda v: setattr(torch.backends.cudnn, "allow_tf32", v), (False, True)),
    "cudnn_deterministic": (lambda: torch.backends.cudnn.deterministic,
                            lambda v: setattr(torch.backends.cudnn, "deterministic", v),
                            (False, True)),
    "deterministic_algorithms": (torch.are_deterministic_algorithms_enabled,
                                 torch.use_deterministic_algorithms, (False, True)),
}


@pytest.mark.parametrize("switch", sorted(GRAPH_SWITCHES))
def test_graph_context_keys_each_switch(switch):
    """A Predictor's and an evaluate's graphs are keyed on `graph_context()`:
    flipping any one switch that a captured forward reads gives another key
    (a graph of its own), and putting it back gives the first key again."""
    read, write, values = GRAPH_SWITCHES[switch]
    was = read()
    try:
        keys = []
        for v in values:
            write(v)
            keys.append(graph_context())
        write(values[0])
        assert keys[0] != keys[1] and graph_context() == keys[0]
    finally:
        write(was)
