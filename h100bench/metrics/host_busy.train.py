"""Share of the traced stretch in which the host works in `Trainer.fit`:
its call spans and their children (the dataset draw, `call_batch`, the
step's launch, the log), less the run-ahead wait (`octave.fit.wait`). The
call under way when the stretch begins counts from its first child there."""
from harness import spans

FIT = ("octave.fit.call", "octave.fit.next_batch", "octave.fit.call_batch",
       "octave.fit.step", "octave.fit.log")


def read(r):
    busy = spans.busy_seconds(r, FIT, ("octave.fit.wait",))
    return None if busy is None else 100.0 * busy / r.window_s
