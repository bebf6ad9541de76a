"""Share of its byte bound the fused decoder epilogue
(`ops/kernels/triton_decoder_epilogue`) reaches in the traced stretch: five
launches a forward (one per gated depth of the configuration), their least
time over their summed device time."""
from harness import roofline


def read(r):
    spent = r.kernel_seconds(roofline.is_epilogue)
    if spent <= 0:
        return None
    bound = roofline.epilogue_bound_s(r.config["per_image"]["epilogue_depths"],
                                      r.workload["batch"], r.config["num_classes"])
    return 100.0 * bound * r.units / spent
