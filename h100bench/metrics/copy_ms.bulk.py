"""Device milliseconds of host-device copies (`serve.Predictor`'s upload and
download streams) per dispatch of the traced stretch."""
from harness import roofline


def read(r):
    spent = r.kernel_seconds(roofline.is_copy)
    if r.units <= 0 or spent <= 0:
        return None
    return 1e3 * spent / r.units
