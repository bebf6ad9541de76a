"""Seconds of int8 calibration (`ops/quant.calibrate`'s eager forwards,
the phase `octave.quant.calibrate` of the Predictor's build) in set-up,
less nvcc's build inside it in a checkout's first run."""
from harness import spans


def read(r):
    return spans.setup_seconds(r, ("octave.quant.calibrate",))
