"""Share of the card's peak the whole served forward (`models/segmentor`
through `serve.Predictor`) reaches: the least time of the images of the
traced stretch at the published peaks (bfloat16 FLOPs at 989 TFLOP/s, int8
operations at 1,979 TOP/s, both counted per image from shapes in the
configuration file) over the stretch's length."""
from harness import roofline


def read(r):
    if r.images <= 0:
        return None
    per = r.config["per_image"]
    least = per["bf16_flops"] / roofline.BF16_FLOPS + per["int8_ops"] / roofline.INT8_OPS
    return 100.0 * least * r.images / r.window_s
