"""Training the gated dual decoders: `Trainer.fit` on `parallel_head_gate`
with its two critics, under `drivers/fit.py`'s protocol.

Set-up builds the Trainer and its state (the segmentor and an
`nn.ModuleDict` of the critics `main` and `c`), puts the seeded weights into
them, and runs fit's first `warm_calls` calls (the eager call, the capture,
the first epoch of the phantoms); the window is every later call until
`--seconds` have passed, and ends synchronised after the last whole call. A
traced run profiles `trace_calls` calls from the window's start. After the
first call the host reads the norm of each leaf's Adam first moment, after
`compared_calls` calls the norm of each leaf's change, and each of those
calls' losses; a forward hook, removed once it has fired, copies the first
step's logits of both heads to the host; the float32 reference (`reference.dual`) follows the same
steps afterwards (`harness.training_dual`).

Workload keys: `steps_per_call`, `warm_calls`, `compared_calls`,
`trace_calls`, `limits`; configuration keys: `program_config` (the Trainer's
configuration), `critic` (each critic's depth and filters).
"""
from __future__ import annotations

import os
import time

from harness.cell import BENCH_DIR, _module

# drivers/fit.py's helpers: its step tap, leaf norms, weight loading and
# program configuration
fit = _module(os.path.join(BENCH_DIR, "drivers", "fit.py"), "h100bench_driver_fit")
program_config = fit.program_config


def run(run):
    import torch

    from harness import device as dev, trace, training_dual
    from harness.cell import Result
    from octave_tpu_torch.train.trainer import Trainer

    wl = run.workload
    conf = program_config(run)
    k, b = conf.train.steps_per_call, conf.data.batch_size
    device = torch.device(run.device)
    trainer = Trainer(conf, device=device)
    state = trainer.init_state()
    seg, crit = training_dual.seeded_weights(run, device)
    fit._load(state.segmentor, seg)
    fit._load(state.critic, crit)
    init = {**{"seg/" + k_: v for k_, v in seg.items()},
            **{"critic/" + k_: v for k_, v in crit.items()}}
    del seg, crit
    dev.release(device)
    dev.reset_peak(device)

    first = {}

    def keep_heads(module, args, output):
        first["heads"] = torch.stack([h.detach().cpu().float() for h in output[1]])
        hook.remove()

    hook = state.segmentor.register_forward_hook(keep_heads)

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
            taken["moments"] = fit._leaf_norms(fit._moments(state))
        if c == compared:
            leaves = fit._program_leaves(state)
            taken["changes"] = fit._leaf_norms({n: leaves[n] - init[n] for n in leaves})
            init.clear()
        if c == warm:
            dev.synchronize(device)
            clock["start"], clock["steps0"] = run.setup_done(), state.step
            if stretch is not None:
                stretch.start()
        if stretch is not None and c == warm + traced:
            readings.append(stretch.stop(traced, traced * k * b))
        if clock["start"] is not None and time.perf_counter() - clock["start"] >= run.seconds:
            raise fit.WindowClosed
        clock["calls"] = c + 1
        return base_call_batch(*args, **kw)

    trainer.call_batch = call_batch
    trainer.step_call = lambda st: fit._StepTap(base_step_call(st), compared, losses)
    try:
        trainer.fit(state)
    except fit.WindowClosed:
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
    checks, got = training_dual.compare(run, conf, program_losses, taken["moments"],
                                        taken["changes"], first["heads"])
    return Result(metrics={"train_img_s": steps * b / elapsed, "peak_gib": peak / 2 ** 30},
                  attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
                  reading=reading, readings=got)
