"""GiB the device's caching allocator reserves more at the end of int8
calibration than at its start (the phase `octave.quant.calibrate`): the
blocks its eager forwards leave cached."""
from harness import spans


def read(r):
    phases = spans.setup_phases(r, ("octave.quant.calibrate",))
    if not phases:
        return None
    return sum(p.reserved_end - p.reserved_start for p in phases) / 2 ** 30
