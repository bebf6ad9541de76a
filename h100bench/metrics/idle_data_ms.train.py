"""Milliseconds per call the device idles while the host's innermost program
span is its data path in `Trainer.fit` (`octave.fit.next_batch`: the dataset
draw; `octave.fit.call_batch`: augmentation, `prepare_batch`, the copy into
the graph's static input): the gaps between the stretch's kernels, each put
down to the span under way where it begins."""
from harness import spans
from harness.trace import gaps

DATA = ("octave.fit.next_batch", "octave.fit.call_batch")


def read(r):
    if r.units <= 0 or not spans.has(r, DATA):
        return None
    program = spans.program(r)
    idle = sum(b - a for a, b in gaps([(s, e) for _, s, e in r.kernels], r.t0,
                                      r.t0 + r.window_s)
               if spans.innermost(program, a) in DATA)
    return 1e3 * idle / r.units
