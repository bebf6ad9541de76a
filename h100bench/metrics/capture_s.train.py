"""Seconds of set-up in the eager warm-ups and the captures of the
graphed train step (`train/steps.GraphedStep`: the phases
`octave.graph.warmup` and `octave.graph.capture`), on the host's clock,
less nvcc's build inside them in a checkout's first run."""
from harness import spans


def read(r):
    return spans.setup_seconds(r, ("octave.graph.warmup", "octave.graph.capture"))
