"""Closed-loop bulk serving: `Predictor.predict_stream` over batches of uint8
angiograms in pinned host buffers, results back on the host as float32
probabilities.

Workload keys: `batch` (images per dispatch), `depth` (dispatches in flight),
`distinct_batches` (pinned batches of distinct phantoms the stream cycles
through in a seeded order; depth + 1 of them also run untimed in set-up),
`trace_dispatches` (the traced stretch),
`rows_per_dispatch` and `sample_dispatches` (the outputs compared),
`limits`.
"""
from __future__ import annotations

import time

import numpy as np


def run(run):
    import torch

    from harness import device, serving, trace
    from harness.cell import Result
    from reference.phantoms import as_rgb

    wl, cfg = run.workload, run.config
    b, hw, n_pool = wl["batch"], cfg["image_size"], wl["distinct_batches"]
    n_cal = cfg["calibration_images"]
    served = serving.seeded_weights(run, n_cal + n_pool * b)
    device.release(run.device)  # the weights' making leaves blocks cached
    device.reset_peak(run.device)
    pred = serving.predictor(run, served, cfg["int8_scope"])
    pred.warmup(b, (hw, hw), ks=(1,))
    bufs = []
    for j in range(n_pool):
        buf = pred.host_buffer((b, hw, hw, 3), np.uint8)
        lo = n_cal + j * b
        torch.from_numpy(buf).copy_(as_rgb(served.images[lo:lo + b]).cpu())
        bufs.append(buf)
    params = {k: v.cpu() for k, v in served.params.items()}
    del served
    rng = np.random.default_rng([run.seed, 3])
    order = np.concatenate([rng.permutation(n_pool) for _ in range(64)])
    # a stream's worth of dispatches in flight, untimed: the pinned blocks
    # of its downloads are allocated here, not in the window
    for _ in pred.predict_stream(bufs[: wl["depth"] + 1], wl["depth"]):
        pass

    reading = None
    if run.trace:
        n = wl["trace_dispatches"]
        stretch = trace.Stretch(cfg, wl)
        stretch.start()
        for _ in pred.predict_stream((bufs[order[i]] for i in range(n)), wl["depth"]):
            pass
        reading = stretch.stop(n, n * b)

    sent, kept = [], []

    def stream(end):
        i = 0
        while time.perf_counter() < end:
            sent.append(int(order[i % len(order)]))
            yield bufs[sent[-1]]
            i += 1

    start = run.setup_done()
    for i, out in enumerate(pred.predict_stream(stream(start + run.seconds), wl["depth"])):
        rows = serving.kept_rows(run.seed, i, b, wl["rows_per_dispatch"])
        kept.append((sent[i], rows, out[rows].copy()))
    elapsed = time.perf_counter() - start
    peak = device.peak_reserved(run.device)
    n_disp = len(kept)

    del pred
    device.release(run.device)
    units = serving.chosen_units(run.seed, n_disp, wl["sample_dispatches"])
    images = np.concatenate([bufs[kept[u][0]][kept[u][1], ..., 0] for u in units])
    served_out = np.concatenate([kept[u][2] for u in units])
    gaps = serving.compare(run, {k: v.to(run.device) for k, v in params.items()},
                           torch.from_numpy(images).to(run.device), served_out)
    return Result(metrics={"serve_img_s": n_disp * b / elapsed, "peak_gib": peak / 2 ** 30},
                  attempted=n_disp * b, failed=0, checks=serving.checks(run, gaps),
                  memory_peak_bytes=peak, reading=reading, readings=gaps)
