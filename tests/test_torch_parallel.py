"""Data parallelism of the port (`octave_tpu_torch/parallel/ddp.py` and its
wiring) on the CPU: two gloo ranks against the full batch in one process and
against the JAX package's data mesh.

One spawn of two ranks (a `file://` store under the test's temporary
directory, two PyTorch threads each) runs every check that needs a process
group (`_rank_checks`) and hands back what the main process compares:
  * synchronised batch norm, forward and gradient, float64, against torch's
    own batch norm over the full batch: 1e-12;
  * the toy step of tests/test_parallel.py:111-183 (conv, batch norm, max
    and avg pools, the plain AAG, WPCE with global counts, ILD, SGD) in
    float64: 2 ranks against 1 process 1e-12, and against the JAX step over
    `make_mesh(2)` on the conftest's virtual devices 1e-10;
  * WPCE with global class counts: the mean over ranks equals the full
    batch's loss, float64, 1e-12;
  * `Trainer` with train.data_parallel at 32² (2 steps, noise off) against
    the single-device `Trainer` in float32, with the bounds of
    tests/test_parallel.py:221-241 (loss_sup 1e-5, every loss 1e-4
    relative, segmentor update by relative L2 under 0.10, BN running stats
    rtol 3e-3 atol 1e-3), and both ranks' states bitwise equal;
  * `evaluate` over a test split whose last batch is ragged (3 samples on 2
    ranks): exactly the single-device metrics;
  * checkpoints: the 2-rank checkpoint restores into a single-device state
    bit for bit, and a 1-device checkpoint resumes on 2 ranks; the step
    after each resume agrees with the single-device step within the bounds
    above;
  * a SIGTERM on one rank stops both at the same step (during the resumed
    run from the 2-rank checkpoint);
  * train.remat='conv' with train.steps_per_call=2 trains the 2 steps bit
    for bit as the plain 2-rank run.
Checkpoints (~0.9 GB each) are copied as hard links: a save writes a new
step directory and renames it into place, never into a restored file.
"""
import functools
import hashlib
import json
import os
import shutil
import signal
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from octave_tpu_torch.losses.segmentor import weighted_partial_ce
from octave_tpu_torch.models.segmentor import AdversarialAttentionGate
from octave_tpu_torch.ops.norm import BatchNorm2d, synchronize_batch_norm
from octave_tpu_torch.parallel import ddp
from octave_tpu_torch.train.state import TrainState
from octave_tpu_torch.train.steps import StepConfig, make_train_step
from octave_tpu_torch.train.trainer import Trainer
from octave_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict
from octave_tpu_torch.utils.config import Config
from port_fixtures import few_torch_threads  # noqa: F401

WORLD = 2
F64_TOL = 1e-12
JAX_TOL = 1e-10
SMOKE = Path(__file__).resolve().parents[1] / "configs" / "synthetic_smoke.json"
# 7 test phantoms in batches of 4: the last batch has 3, padded to 4 on 2 ranks
TRAINER = {"train.steps": "2", "data.image_size": "[32,32]", "data.synthetic_n": "7",
           "data.batch_size": "4", "train.eval_every": "0", "train.log_every": "1",
           "model.instance_noise": "false", "model.label_noise": "false"}
LOSS_ATOL, LOSS_RTOL, UPDATE_L2, BN_RTOL, BN_ATOL = 1e-5, 1e-4, 0.10, 3e-3, 1e-3
STEP2_RTOL = 0.10
LOSSES = ("loss_sup", "loss_ild", "loss_adv", "loss_seg_total", "loss_disc")


def _trainer_cfg(**extra):
    return Config.load(str(SMOKE)).apply_overrides({**TRAINER, **extra})


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A full train state is ~0.9 GB on disk: leave none behind."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- the toy models -------------------------------------------------------------
class ToyBN(nn.Module):
    """conv, BN, ReLU, strided conv, BN (tests/test_parallel.py:57-67)."""

    def __init__(self):
        super().__init__()
        self.c1, self.b1 = nn.Conv2d(3, 8, 3, 1, 1), BatchNorm2d(8)
        self.c2, self.b2 = nn.Conv2d(8, 4, 3, 2, 1), BatchNorm2d(4)

    def forward(self, x):
        return self.b2(self.c2(F.relu(self.b1(self.c1(x)))))


class ToySeg(nn.Module):
    """The JAX ToySeg of tests/test_parallel.py:126-143, NCHW inside,
    (attentions, agg map, x) out like ResnestUNet, y_hat and agg NHWC."""

    def __init__(self):
        super().__init__()
        self.c1, self.b1 = nn.Conv2d(3, 8, 3, 1, 1), BatchNorm2d(8)
        self.c2, self.b2 = nn.Conv2d(8, 8, 3, 1, 1), BatchNorm2d(8)
        self.aag1, self.c3 = AdversarialAttentionGate(8, 2), nn.Conv2d(8, 8, 3, 1, 1)
        self.aag0, self.fc = AdversarialAttentionGate(8, 2), nn.Conv2d(8, 2, 1)

    def forward(self, image):
        x = F.relu(self.b1(self.c1(image.permute(0, 3, 1, 2))))
        h = self.b2(self.c2(F.max_pool2d(x, 3, 2, 1)))
        h, y1 = self.aag1(F.avg_pool2d(h, 3, 1, 1))
        up = self.c3(h.repeat_interleave(2, 2).repeat_interleave(2, 3))
        d0, y0 = self.aag0(up)
        return (y0, y1), self.fc(d0).permute(0, 2, 3, 1), h


@functools.lru_cache(maxsize=None)
def _toy_data():
    """float64 inputs made from seeds with numpy: the BN toy's (x, target)
    and the toy step's image and scribbles (as tests/test_parallel.py)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3, 8, 8))
    tgt = rng.standard_normal((8, 4, 4, 4))
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (8, 16, 16, 3))
    mask = (rng.uniform(0, 1, (8, 16, 16)) > 0.6).astype(np.int64)
    scrib = np.where(rng.uniform(0, 1, (8, 16, 16)) < 0.3, mask + 1, 0)
    onehot = (scrib[..., None] == np.arange(1, 3)).astype(np.float64)  # classes 1, 2 -> 0, 1
    return x, tgt, img, onehot, scrib


@functools.lru_cache(maxsize=None)
def _toy_variables():
    """The toy's variables in the JAX ToySeg's tree (float64 numpy), made
    from a seed: convs uniform in +-1/sqrt(fan in), BN scales and biases
    away from their 1 and 0 so the step moves them too."""
    rng = np.random.default_rng(1)
    params = {}
    for name, k, cin, cout in (("c1", 3, 3, 8), ("c2", 3, 8, 8), ("c3", 3, 8, 8), ("fc", 1, 8, 2),
                               ("aag1", 1, 8, 2), ("aag0", 1, 8, 2)):
        bound = 1 / np.sqrt(k * k * cin)
        conv = {"kernel": rng.uniform(-bound, bound, (k, k, cin, cout)),
                "bias": rng.uniform(-bound, bound, cout)}
        params[name] = {"conv1": {"conv": conv}} if name.startswith("aag") else {"conv": conv}
    for name in ("b1", "b2"):
        params[name] = {"scale": rng.uniform(0.5, 1.5, 8), "bias": rng.uniform(-0.5, 0.5, 8)}
    stats = {name: {"mean": np.zeros(8), "var": np.ones(8)} for name in ("b1", "b2")}
    return {"params": params, "batch_stats": stats}


def _jax_toy_seg():
    """The JAX ToySeg of tests/test_parallel.py:126-143."""
    import flax.linen as jnn
    import jax
    import jax.numpy as jnp

    from octave_tpu.models.resnest import Conv
    from octave_tpu.models.segmentor import AdversarialAttentionGate as JaxAAG
    from octave_tpu.ops.common import avg_pool2d, max_pool2d
    from octave_tpu.ops.norm import BatchNorm

    class JaxToySeg(jnn.Module):
        axis: str = None

        @jnn.compact
        def __call__(self, x, train=True):
            x = Conv(8, 3, 1, 1, name="c1")(x)
            x = BatchNorm(8, axis_name=self.axis, name="b1")(x, train)
            x = jnn.relu(x)
            h = max_pool2d(x, 3, 2, 1)
            h = Conv(8, 3, 1, 1, name="c2")(h)
            h = BatchNorm(8, axis_name=self.axis, name="b2")(h, train)
            h = avg_pool2d(h, 3, 1, 1)
            h, y1 = JaxAAG(8, 2, name="aag1")(h)
            up = jnp.repeat(jnp.repeat(h, 2, 1), 2, 2)
            up = Conv(8, 3, 1, 1, name="c3")(up)
            d0, y0 = JaxAAG(8, 2, name="aag0")(up)
            agg = Conv(2, 1, 1, 0, name="fc")(d0)
            return (y0, y1), agg, h

    return JaxToySeg


def _port_toy(variables) -> ToySeg:
    """A float64 port ToySeg holding the JAX variables."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ("c1", "c2", "c3", "fc", "aag1", "aag0"):
        conv = p[name]["conv1"]["conv"] if name.startswith("aag") else p[name]["conv"]
        key = f"{name}.conv1" if name.startswith("aag") else name
        sd[f"{key}.weight"] = conv["kernel"].transpose(3, 2, 0, 1)
        sd[f"{key}.bias"] = conv["bias"]
    for name in ("b1", "b2"):
        sd.update({f"{name}.weight": p[name]["scale"], f"{name}.bias": p[name]["bias"],
                   f"{name}.running_mean": s[name]["mean"], f"{name}.running_var": s[name]["var"]})
    model = ToySeg().double()
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing), missing
    return model


def _toy_step(model, rows=slice(None), data_parallel=False):
    """One port SGD(0.1) step of the toy on `rows` of the batch: (losses,
    new parameters and BN stats), as numpy."""
    _, _, img, onehot, _ = _toy_data()
    synchronize_batch_norm(model, data_parallel)
    state = TrainState(segmentor=model, seg_opt=torch.optim.SGD(model.parameters(), lr=0.1))
    step = make_train_step(StepConfig(num_classes=2, use_discriminator=False,
                                      data_parallel=data_parallel))
    losses = step(state, {"image": torch.from_numpy(img[rows]),
                          "scribble_onehot": torch.from_numpy(onehot[rows])})
    return ({k: float(v) for k, v in losses.items()},
            {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")})


def _digest(state) -> str:
    """sha256 over every tensor of a TrainState's modules."""
    h = hashlib.sha256()
    for part in (state.segmentor, state.critic):
        for k, v in sorted(part.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _losses(log_dir) -> list:
    return [json.loads(line) for line in open(Path(log_dir) / "metrics.jsonl")]


def _first_step(state) -> dict:
    """Filled at the segmentor's first optimizer step: its gradient (the
    mean over ranks under data parallelism) and its BN running stats."""
    seen, step = {}, state.seg_opt.step

    def record_then_step():
        if not seen:
            seg = state.segmentor
            seen.update({f"grad:{k}": p.grad.clone() for k, p in seg.named_parameters()
                         if p.grad is not None})
            seen.update({k: v.clone() for k, v in seg.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))})
        step()

    state.seg_opt.step = record_then_step
    return seen


# -- what each rank runs -----------------------------------------------------
def _rank_checks(device, work: str, jax_variables) -> dict:
    torch.set_num_threads(2)
    work = Path(work)
    r, n = ddp.rank(), ddp.world()
    rows = ddp.shard_rows(8, r, n)
    out = {}

    # synchronised batch norm: forward, gradient and running stats
    x, tgt, _, onehot, _ = _toy_data()
    torch.manual_seed(0)
    toy = synchronize_batch_norm(ToyBN().double())
    y = toy(torch.from_numpy(x[rows]))
    ((y - torch.from_numpy(tgt[rows])) ** 2).mean().backward()
    grads = [p.grad for p in toy.parameters()]
    ddp.all_reduce_mean_(grads)
    out["bn"] = {"y": y.detach().numpy(), "grads": [g.numpy() for g in grads],
                 "stats": {k: v.numpy() for k, v in toy.state_dict().items()}}

    # WPCE with global class counts
    rng = np.random.default_rng(3)
    probs = rng.dirichlet([1.0, 1.0], size=(8, 6, 6))
    out["wpce"] = float(weighted_partial_ce(torch.from_numpy(probs[rows]),
                                            torch.from_numpy(onehot[rows, ::3, ::3]), 2,
                                            global_counts=True))

    # the toy step
    out["toy"] = _toy_step(_port_toy(jax_variables), rows, data_parallel=True)

    # the Trainer: 2 steps and a checkpoint
    cfg = _trainer_cfg(**{"train.data_parallel": "true", "train.n_devices": str(n),
                          "train.checkpoint_dir": str(work / "ckpt_dp"),
                          "train.log_dir": str(work / "log_dp")})
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    first = _first_step(state)
    state = trainer.fit(state)
    out["digest"] = _digest(state)
    if r == 0:
        out["first"] = {k: v.numpy() for k, v in first.items()}
        out["losses"] = _losses(work / "log_dp")

    # the same 2 steps as one call, with the whole forward one recomputed
    # region that keeps its conv outputs (the synchronised BN all-reduces
    # again in the recompute, under the selective checkpoint's dispatch)
    cfg = _trainer_cfg(**{"train.data_parallel": "true", "train.n_devices": str(n),
                          "train.remat": "conv", "train.steps_per_call": "2"})
    out["digest_switches"] = _digest(Trainer(cfg, device=device).fit())

    # evaluate: sharded with a padded tail, and the single-device evaluate
    out["eval_dp"] = trainer.evaluate(state)
    if r == 0:
        out["eval_single"] = Trainer(_trainer_cfg(), device=device).evaluate(state)

    # step 3 on 2 ranks, resumed from the 2-rank checkpoint and from the
    # 1-device one (rank 0 alone writes, so the ranks share one copy). The
    # run from the 2-rank one is asked for 4 steps, and rank 1 alone gets a
    # SIGTERM during step 3: every rank saves step 3 and stops there
    for src in ("dp", "single"):
        ckpt, logs = work / f"resume_{src}", work / f"log_resume_{src}"
        if r == 0:
            shutil.copytree(work / f"ckpt_{src}", ckpt, copy_function=os.link)
        ddp.barrier()
        cfg = _trainer_cfg(**{"train.data_parallel": "true",
                              "train.steps": "4" if src == "dp" else "3",
                              "train.checkpoint_dir": str(ckpt), "train.log_dir": str(logs)})
        trainer = Trainer(cfg, device=device)
        if src == "dp":
            step = trainer.train_step

            def step_then_sigterm(state, batch):
                losses = step(state, batch)
                if r == 1 and state.step == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                return losses

            trainer.train_step = step_then_sigterm
        state = trainer.fit()
        out[f"resumed_{src}"] = (state.step, _losses(logs)[-1] if r == 0 else None)
        if src == "dp":
            out["sigterm"] = (state.step, sorted(os.listdir(ckpt)))
    return out


# -- the spawn and the single-process references -------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir, first-step record of one device, [rank 0's results, rank
    1's]) of one 2-rank spawn. Before it, the single-device Trainer's 2
    steps (its log and checkpoint), which the ranks resume from."""
    work = tmp_path_factory.mktemp("ddp")
    cfg = _trainer_cfg(**{"train.checkpoint_dir": str(work / "ckpt_single"),
                          "train.log_dir": str(work / "log_single")})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    first = _first_step(state)
    trainer.fit(state)
    results = ddp.launch(_rank_checks, WORLD, "gloo", ["cpu"] * WORLD,
                         args=(str(work), _toy_variables()), timeout=600)
    yield work, {k: v.numpy() for k, v in first.items()}, results
    shutil.rmtree(work, ignore_errors=True)  # checkpoints of ~0.9 GB each


def test_shard_rows():
    assert [ddp.shard_rows(8, r, 2) for r in range(2)] == [slice(0, 4), slice(4, 8)]
    assert ddp.shard_rows(6, 2, 3) == slice(4, 6)
    with pytest.raises(ValueError, match="equal shards"):
        ddp.shard_rows(5, 0, 2)
    with pytest.raises(ValueError, match="outside"):
        ddp.shard_rows(4, 2, 2)
    assert ddp.world() == 1 and ddp.rank() == 0 and not ddp.is_distributed()


def _formula_batch_norm(bn, x):
    """The JAX training batch norm (octave_tpu/ops/norm.py:123-138) as plain
    autograd in one process: statistics in at least float32 from an upcast
    copy, var = max(mean2 - mean^2, 0), the running variance unbiased."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, mean2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var * (n / (n - 1)), alpha=bn.momentum)
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * scale
    return torch.addcmul(shift.to(x.dtype).view(1, -1, 1, 1), x,
                         scale.to(x.dtype).view(1, -1, 1, 1))


def test_sync_batch_norm_equals_the_formula_under_autograd():
    """Without a process group the synchronised BN is the JAX formula on
    the local batch: its analytic backward equals autograd through the
    formula in float64 (1e-12; an input of mean 3 and std 2, channels_last),
    and passes gradcheck."""
    from octave_tpu_torch.ops.norm import _SyncBatchNorm

    gen = torch.Generator().manual_seed(0)
    bn = synchronize_batch_norm(BatchNorm2d(5).double())
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-1, 1, generator=gen)
    ref = BatchNorm2d(5).double()
    ref.load_state_dict(bn.state_dict())
    x = (torch.randn(4, 5, 6, 7, generator=gen, dtype=torch.float64) * 2 + 3)
    x = x.to(memory_format=torch.channels_last).requires_grad_()
    g = torch.randn(4, 5, 6, 7, generator=gen, dtype=torch.float64)
    got, want = [], []
    for module, fn, out in ((bn, bn, got), (ref, functools.partial(_formula_batch_norm, ref), want)):
        y = fn(x)
        (y * g).sum().backward()
        out += [y.detach().clone(), x.grad.clone(), module.weight.grad, module.bias.grad,
                module.running_mean, module.running_var]
        x.grad = None
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=F64_TOL)
    small = [torch.randn(3, 4, 3, 2, generator=gen, dtype=torch.float64, requires_grad=True),
             torch.rand(4, generator=gen, dtype=torch.float64, requires_grad=True),
             torch.randn(4, generator=gen, dtype=torch.float64, requires_grad=True)]
    assert torch.autograd.gradcheck(lambda *a: _SyncBatchNorm.apply(*a, 1e-5)[0], small)


def test_sync_batch_norm_equals_full_batch_f64(runs):
    res = runs[2]
    x, tgt = _toy_data()[:2]
    torch.manual_seed(0)
    full = ToyBN().double()  # torch's own batch norm over all 8 samples
    y = full(torch.from_numpy(x))
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    for r in range(WORLD):
        got = res[r]["bn"]
        rows = ddp.shard_rows(8, r, WORLD)
        np.testing.assert_allclose(got["y"], y.detach().numpy()[rows], rtol=0, atol=F64_TOL)
        for g, p in zip(got["grads"], full.parameters()):
            np.testing.assert_allclose(g, p.grad.numpy(), rtol=0, atol=F64_TOL)
        for k, v in full.state_dict().items():
            np.testing.assert_allclose(got["stats"][k], v.numpy(), rtol=0, atol=F64_TOL)


def test_wpce_global_counts(runs):
    res = runs[2]
    onehot = _toy_data()[3]
    probs = np.random.default_rng(3).dirichlet([1.0, 1.0], size=(8, 6, 6))
    full = float(weighted_partial_ce(torch.from_numpy(probs),
                                     torch.from_numpy(onehot[:, ::3, ::3]), 2))
    local = float(weighted_partial_ce(torch.from_numpy(probs[:4]),
                                      torch.from_numpy(onehot[:4, ::3, ::3]), 2))
    mean = np.mean([res[r]["wpce"] for r in range(WORLD)])
    assert abs(mean - full) <= F64_TOL * abs(full)
    assert abs(res[0]["wpce"] - local) > 1e-6  # the global counts did change the weights


def test_toy_step_two_ranks_equal_one_process_and_jax_f64(runs):
    """The whole step machinery: sharded == full batch in float64, and equal
    to the JAX step over a 2-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from octave_tpu.data.preprocess import scribble_to_onehot
    from octave_tpu.parallel.mesh import DATA_AXIS, make_mesh, make_parallel_train_step
    from octave_tpu.parallel.mesh import replicate, shard_batch
    from octave_tpu.train.state import TrainState as JaxState
    from octave_tpu.train.steps import StepConfig as JaxStepConfig
    from octave_tpu.train.steps import make_train_step as jax_make_train_step

    res = runs[2]
    JaxToySeg, variables = _jax_toy_seg(), _toy_variables()
    one_losses, one_state = _toy_step(_port_toy(variables))
    for r in range(WORLD):
        losses, state = res[r]["toy"]
        for k, v in one_losses.items():
            assert abs(losses[k] - v) <= F64_TOL, (k, losses[k], v)
        for k, v in one_state.items():
            np.testing.assert_allclose(state[k], v, rtol=0, atol=F64_TOL, err_msg=k)

    _, _, img, onehot, scrib = _toy_data()
    with jax.enable_x64():
        f64 = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
        v = f64(variables)
        batch = {"image": jnp.asarray(img),
                 "scribble_onehot": scribble_to_onehot(jnp.asarray(scrib), 2).astype(jnp.float64)}
        np.testing.assert_array_equal(np.asarray(batch["scribble_onehot"]), onehot)
        mesh = make_mesh(WORLD)
        st = replicate(JaxState.create(seg_params=v["params"], batch_stats=v["batch_stats"],
                                       seg_tx=optax.sgd(0.1), rng=jax.random.PRNGKey(7)), mesh)
        step = make_parallel_train_step(jax_make_train_step(
            JaxToySeg(axis=DATA_AXIS), None,
            JaxStepConfig(num_classes=2, use_discriminator=False, axis_name=DATA_AXIS)), mesh)
        new, jlosses = step(st, shard_batch(batch, mesh))
        jparams = jax.tree.map(np.asarray, new.seg_params)
        jstats = jax.tree.map(np.asarray, new.batch_stats)
    losses, state = res[0]["toy"]
    for k in ("loss_sup", "loss_ild", "loss_seg_total"):
        assert abs(losses[k] - float(jlosses[k])) <= JAX_TOL, k
    want = _port_toy({"params": jparams, "batch_stats": jstats}).state_dict()
    for k, v in state.items():
        np.testing.assert_allclose(v, want[k].numpy(), rtol=0, atol=JAX_TOL, err_msg=k)


def test_trainer_two_ranks_match_one_device(runs):
    """float32, 2 steps at 32² with the critic, against one device on the
    full batch. The bounds of tests/test_parallel.py:221-241, which hold
    one SGD step, hold the first step: its losses, its mean gradient (what
    an SGD update is proportional to) and the BN running stats it leaves.
    Adam's first update is lr * sign(g) wherever |g| >> eps, so elements
    whose gradient is at float32 noise flip by 2 lr and the second step
    starts from states that differ by that: there the replicas must be
    bitwise equal and the losses within STEP2_RTOL of one device's."""
    work, first, res = runs
    assert res[0]["digest"] == res[1]["digest"], "the replicas diverged"
    single = _losses(work / "log_single")
    dp = res[0]["losses"]
    assert [r["step"] for r in dp] == [r["step"] for r in single] == [1, 2]
    (a, a2), (b, b2) = dp, single
    assert abs(a["train/loss_sup"] - b["train/loss_sup"]) < LOSS_ATOL
    for k in LOSSES:
        assert abs(a[f"train/{k}"] - b[f"train/{k}"]) <= LOSS_RTOL * abs(b[f"train/{k}"]), k
        assert abs(a2[f"train/{k}"] - b2[f"train/{k}"]) <= STEP2_RTOL * abs(b2[f"train/{k}"]), k
    got = res[0]["first"]
    assert got.keys() == first.keys()
    num = sum(float(((got[k] - v) ** 2).sum()) for k, v in first.items() if k.startswith("grad:"))
    den = sum(float((v ** 2).sum()) for k, v in first.items() if k.startswith("grad:"))
    assert (num / den) ** 0.5 < UPDATE_L2, (num / den) ** 0.5
    for k, v in first.items():
        if not k.startswith("grad:"):
            np.testing.assert_allclose(got[k], v, rtol=BN_RTOL, atol=BN_ATOL, err_msg=k)


def test_remat_and_steps_per_call_change_nothing_on_two_ranks(runs):
    """train.remat='conv' with train.steps_per_call=2 on 2 ranks trains what
    the plain 2-rank run trains, bit for bit: the recompute repeats the
    forward and its all-reduces, the BN statistics update once."""
    res = runs[2]
    assert res[0]["digest_switches"] == res[1]["digest_switches"] == res[0]["digest"]


def test_evaluate_ragged_tail_equals_one_device(runs):
    res = runs[2]
    assert res[0]["eval_dp"] == res[1]["eval_dp"] == res[0]["eval_single"]


@pytest.mark.parametrize("src", ["dp", "single"])
def test_checkpoints_cross_between_one_device_and_two_ranks(runs, tmp_path, src):
    """A 2-rank checkpoint restores bit for bit into a 1-device state, and
    either kind resumes on 1 device and on 2 ranks: step 3 from the same
    checkpoint agrees within the data-parallel bounds. A resume goes on
    with the batch order of an uninterrupted run: from the 1-device
    checkpoint, 1-device step 3 is the uninterrupted 3-step run's step 3,
    exactly, and 2 ranks agree with that run within the bounds."""
    work, _, res = runs
    cfg = _trainer_cfg(**{"train.steps": "3", "train.log_dir": str(tmp_path / "log")})
    trainer = Trainer(cfg, device="cpu")
    restored = CheckpointManager(str(work / f"ckpt_{src}")).restore_latest(trainer.init_state())
    assert restored.step == 2
    if src == "dp":
        assert _digest(restored) == res[0]["digest"]
    state = trainer.fit(restored)
    assert state.step == 3 and state_to_dict(state)["step"] == 3
    one = _losses(tmp_path / "log")[-1]
    (step0, two), (step1, _) = res[0][f"resumed_{src}"], res[1][f"resumed_{src}"]
    assert step0 == step1 == 3 and one["step"] == two["step"] == 3
    for k in LOSSES:
        assert abs(one[f"train/{k}"] - two[f"train/{k}"]) <= LOSS_RTOL * abs(two[f"train/{k}"]), k
    if src == "single":
        Trainer(_trainer_cfg(**{"train.steps": "3", "train.log_dir": str(tmp_path / "whole")}),
                device="cpu").fit()
        whole = _losses(tmp_path / "whole")[-1]
        assert whole["step"] == 3
        for k in LOSSES:
            assert one[f"train/{k}"] == whole[f"train/{k}"], k
            assert abs(two[f"train/{k}"] - whole[f"train/{k}"]) <= (
                LOSS_RTOL * abs(whole[f"train/{k}"])), k


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(runs):
    """Rank 1 alone receives SIGTERM during step 3 of a run resumed at step
    2 and asked for 4; the flag is all-reduced with the step, so both ranks
    stop after step 3 and rank 0 saves it beside the step it resumed from."""
    res = runs[2]
    assert res[0]["sigterm"] == res[1]["sigterm"] == (3, ["step_00000002", "step_00000003"])


def test_data_parallel_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(_trainer_cfg(**{"train.data_parallel": "true"}), device="cpu")
    with pytest.raises(ValueError, match="needs train.data_parallel"):
        Trainer(_trainer_cfg(**{"train.n_devices": "2"}), device="cpu")
