"""Share of its roofline the int8 conv kernel (`ops/kernels/int8_conv`,
`csrc/int8_conv.cuh`) reaches in the traced stretch: the summed least time
of its launches (the configuration's int8 sites at the cell's batch, once
per forward) over its summed device time, matched by kernel name."""
from harness import roofline


def read(r):
    spent = r.kernel_seconds(roofline.is_int8_conv)
    if spent <= 0:
        return None
    forwards = r.units  # one forward per dispatch of a stack of one
    bound = roofline.int8_forward_bound_s(r.config["per_image"]["int8_sites"],
                                          r.workload["batch"])
    return 100.0 * bound * forwards / spent
