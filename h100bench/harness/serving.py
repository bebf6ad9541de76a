"""Set-up and check of the serving cells: seeded weights, the Predictor of
the configuration, its traffic images, and the comparison of served outputs
with the float32 reference."""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, List

import numpy as np

from harness.cell import Check


@dataclasses.dataclass
class Served:
    params: Dict  # the seeded float32 weights (reference names, BN stats set)
    images: object  # (n, hw, hw) uint8 device phantoms: calibration first, then traffic


def seeded_weights(run, n_images: int):
    """The weights and the phantoms of this seed, made on the device."""
    import torch

    from reference.model import bn_statistics, make_params, segmentor_spec
    from reference.phantoms import as_rgb, device_phantoms

    cfg = run.config
    hw = cfg["image_size"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    params = make_params(segmentor_spec(), gen, torch.device(run.device))
    images = device_phantoms(n_images, hw, gen)
    with torch.no_grad(), reference_precision():
        n = cfg["bn_statistics_images"]
        x = as_rgb(images[:n]).float().div_(255.0)
        params.update(bn_statistics(params, x))
    return Served(params, images)


@contextlib.contextmanager
def reference_precision():
    """float32 without TF32 while the reference computes."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def predictor(run, served: Served, int8_scope: str):
    """The configuration's Predictor on the seeded weights, calibrated on
    the first `calibration_images` phantoms."""
    from octave_tpu_torch.serve import Predictor
    from reference.phantoms import as_rgb

    cfg = run.config
    calib = as_rgb(served.images[:cfg["calibration_images"]])
    return Predictor(served.params, int8_decoder=True, calibration_batches=[calib],
                     int8_scope=int8_scope, dense_groups=cfg["dense_groups"],
                     output_format="prob_f32", device=run.device)


def served_gaps(prob: np.ndarray, ref: np.ndarray, yard: np.ndarray) -> Dict[str, float]:
    """Numbers of served probabilities (n, h, w, K) against the reference's
    (`ref`) and the reference's in the configuration's own precision
    (`yard`), with z the log-odds of the vessel class recovered from the
    probabilities. `logit_rel_err`: per image the median over its pixels of
    |z - z_ref| / max(|z_ref|, 1), the worst image's; an image whose answer
    is altered reads about 1 or more. `excess_gap`: the mean |z - z_ref| over
    the yardstick's mean |z_yard - z_ref|, less 1: about 0 at the stated
    precision, above it where more of the network runs lower. Beside them:
    the largest and the mean absolute difference of a probability and the
    share of pixels whose class differs."""
    def log_odds(p):
        return np.log(np.maximum(p[..., -1], 1e-38)) - np.log(np.maximum(p[..., 0], 1e-38))

    z, z_ref = log_odds(prob), log_odds(ref)
    gap = np.abs(z - z_ref)
    rel = gap / np.maximum(np.abs(z_ref), 1.0)
    per_image = np.median(rel.reshape(rel.shape[0], -1), axis=1)
    diff = np.abs(prob - ref)
    return {"logit_rel_err": float(per_image.max()),
            "excess_gap": float(gap.mean() / np.abs(log_odds(yard) - z_ref).mean() - 1.0),
            "prob_max_abs": float(diff.max()), "prob_mean_abs": float(diff.mean()),
            "class_flip_share": float((prob.argmax(-1) != ref.argmax(-1)).mean())}


def reference_outputs(params, images_u8, block: int = 8, precision=None) -> np.ndarray:
    """The reference's probabilities for (n, hw, hw) uint8 device images,
    in blocks of `block`; `precision` is a `reference.model.Precision` mode
    (the yardstick and the controls)."""
    import torch

    from reference.model import Precision, segmentor_probabilities
    from reference.phantoms import as_rgb

    out = []
    with torch.no_grad(), reference_precision(), Precision.use(precision):
        for lo in range(0, images_u8.shape[0], block):
            x = as_rgb(images_u8[lo:lo + block]).float().div_(255.0)
            out.append(segmentor_probabilities(params, x).cpu().numpy())
    return np.concatenate(out)


def compare(run, params, images_u8, served: np.ndarray) -> Dict[str, float]:
    """`served_gaps` of the program's outputs for these images, against
    the reference and its yardstick (the configuration's `yardstick`
    precision mode) worked out here."""
    ref = reference_outputs(params, images_u8)
    yard = reference_outputs(params, images_u8, precision=run.config["yardstick"])
    return served_gaps(served, ref, yard)


def checks(run, gaps: Dict[str, float]) -> List[Check]:
    """The cell's limits (workload file, `limits`) applied to `gaps`; every
    number of `gaps` is printed to standard error first."""
    print("reading " + "; ".join(f"{k} {v!r}" for k, v in gaps.items()), file=sys.stderr)
    return [Check(name, gaps[name], float(limit))
            for name, limit in run.workload["limits"].items()]


def kept_rows(seed: int, unit: int, batch: int, rows: int) -> np.ndarray:
    """The rows of dispatch `unit` whose outputs a run keeps for the check,
    drawn from the seed."""
    return np.sort(np.random.default_rng([seed, 1, unit]).choice(batch, rows, replace=False))


def chosen_units(seed: int, n_units: int, sample: int) -> List[int]:
    """The dispatches whose kept rows are compared: `sample` drawn from the
    seed, the last one always among them."""
    rng = np.random.default_rng([seed, 2])
    earlier = rng.choice(n_units - 1, size=min(sample, n_units) - 1, replace=False)
    return sorted(int(u) for u in earlier) + [n_units - 1]
