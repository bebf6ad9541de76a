"""Share of the card's bfloat16 peak (989 TFLOP/s) the whole train step
(`train/steps`: the segmentor and the critic, forward and backward) reaches:
the step's FLOPs per image, counted from shapes in the configuration file,
times the images of the traced stretch, over the stretch's length."""
from harness import roofline


def read(r):
    if r.images <= 0:
        return None
    return 100.0 * r.config["per_image"]["train_flops"] * r.images / (
        roofline.BF16_FLOPS * r.window_s)
