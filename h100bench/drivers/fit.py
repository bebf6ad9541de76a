"""Training: `Trainer.fit` on the configuration's adversarial job, with the
benchmark's spans around the trainer's `call_batch` and its step.

Set-up builds the Trainer and its state, puts the seeded weights into it, and
runs fit's first `warm_calls` calls (the eager call, the capture, the first
epoch of the phantoms, which the dataset caches); the window is every later
call until `--seconds` have passed, and ends synchronised after the last
whole call. The first steps are the correctness check's: after the first
call the host reads the norm of each leaf's Adam first moment, after
`compared_calls` calls the norm of each leaf's change, and each of those
calls' losses; the float32 reference follows the same steps afterwards.

Workload keys: `steps_per_call`, `warm_calls`, `compared_calls`,
`trace_calls`, `limits`; configuration keys: `program_config` (the Trainer's
configuration), `critic` (its depth and filters).
"""
from __future__ import annotations

import time

import numpy as np


class WindowClosed(Exception):
    """Raised at a call boundary once the window's time is up."""


class _StepTap:
    """fit's step callable, its losses kept for the first calls."""

    def __init__(self, inner, keep: int, losses: list):
        self.inner, self.keep, self.losses = inner, keep, losses

    def __call__(self, state, batch):
        import torch

        with torch.profiler.record_function("h100bench.step"):
            out = self.inner(state, batch)
        if len(self.losses) < self.keep:
            self.losses.append({k: v.clone() for k, v in out.items()})
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _leaf_norms(tensors: dict):
    import torch

    names = list(tensors)
    with torch.no_grad():
        norms = torch._foreach_norm([tensors[n].detach().float() for n in names])
    return dict(zip(names, torch.stack(norms).cpu().numpy().astype(np.float64)))


def _program_leaves(state) -> dict:
    leaves = {"seg/" + k: p for k, p in state.segmentor.named_parameters()}
    leaves.update({"critic/" + k: p for k, p in state.critic.named_parameters()})
    return leaves


def _moments(state) -> dict:
    """Each leaf's Adam first moment (zeros where the optimizer holds none)."""
    import torch

    leaves = _program_leaves(state)
    opt_state = {**state.seg_opt.opt.state, **state.critic_opt.opt.state}
    return {k: opt_state[p]["exp_avg"] if "exp_avg" in opt_state.get(p, {})
            else torch.zeros_like(p) for k, p in leaves.items()}


def _load(module, params) -> None:
    import torch

    sd = module.state_dict()
    if set(sd) != set(params):
        raise KeyError(f"weights and module differ: {sorted(set(sd) ^ set(params))[:8]}")
    with torch.no_grad():
        for k, t in sd.items():
            t.copy_(params[k])


def program_config(run):
    from octave_tpu_torch.utils.config import Config

    wl = run.workload
    conf = Config.from_dict(run.config["program_config"])
    conf.train.seed = run.seed
    conf.train.steps_per_call = wl["steps_per_call"]
    conf.train.steps = 10 ** 12  # the window, not a step count, ends the fit
    return conf


def run(run):
    import torch

    from harness import device as dev, trace, training
    from harness.cell import Result
    from octave_tpu_torch.train.trainer import Trainer

    wl = run.workload
    conf = program_config(run)
    k, b = conf.train.steps_per_call, conf.data.batch_size
    device = torch.device(run.device)
    trainer = Trainer(conf, device=device)
    state = trainer.init_state()
    seg, crit = training.seeded_weights(run, device)
    _load(state.segmentor, seg)
    _load(state.critic, crit)
    init = {**{"seg/" + k_: v for k_, v in seg.items()},
            **{"critic/" + k_: v for k_, v in crit.items()}}
    del seg, crit
    dev.release(device)
    dev.reset_peak(device)

    losses: list = []
    taken = {}
    clock = {"calls": 0, "start": None, "steps0": 0}
    stretch = trace.Stretch(run.config, wl) if run.trace else None
    readings = []
    warm, compared, traced = wl["warm_calls"], wl["compared_calls"], wl["trace_calls"]
    base_call_batch = trainer.call_batch
    base_step_call = trainer.step_call

    def call_batch(*args, **kw):
        c = clock["calls"]
        if c == 1:
            taken["moments"] = _leaf_norms(_moments(state))
        if c == compared:
            leaves = _program_leaves(state)
            taken["changes"] = _leaf_norms({n: leaves[n] - init[n] for n in leaves})
            init.clear()
        if c == warm:
            dev.synchronize(device)
            clock["start"], clock["steps0"] = run.setup_done(), state.step
            if stretch is not None:
                stretch.start()
        if stretch is not None and c == warm + traced:
            readings.append(stretch.stop(traced, traced * k * b))
        if clock["start"] is not None and time.perf_counter() - clock["start"] >= run.seconds:
            raise WindowClosed
        clock["calls"] = c + 1
        with torch.profiler.record_function("h100bench.call_batch"):
            return base_call_batch(*args, **kw)

    trainer.call_batch = call_batch
    trainer.step_call = lambda st: _StepTap(base_step_call(st), compared, losses)
    try:
        trainer.fit(state)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("fit ended before the window closed")
    dev.synchronize(device)
    elapsed = time.perf_counter() - clock["start"]
    steps = state.step - clock["steps0"]
    peak = dev.peak_reserved(device)
    program_losses = [{n: float(v) for n, v in d.items()} for d in losses]
    reading = readings[0] if readings else None
    if state.graph is not None:
        state.graph.close()
    del state, trainer
    dev.release(device)
    checks, got = training.compare(run, conf, program_losses, taken["moments"],
                                   taken["changes"])
    return Result(metrics={"train_img_s": steps * b / elapsed, "peak_gib": peak / 2 ** 30},
                  attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
                  reading=reading, readings=got)
