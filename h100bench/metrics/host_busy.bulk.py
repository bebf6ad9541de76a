"""Share of the traced stretch in which the host works inside
`serve.Predictor`: its dispatch spans (the upload's enqueue, the replay, the
event) and its result spans (the download's enqueue, the copy into numpy),
less the result's wait for the download (`octave.predictor.wait`)."""
from harness import spans


def read(r):
    busy = spans.busy_seconds(r, ("octave.predictor.dispatch", "octave.predictor.result"),
                              ("octave.predictor.wait",))
    return None if busy is None else 100.0 * busy / r.window_s
