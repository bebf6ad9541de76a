"""Batched inference: the port of octave_tpu/serve.py::Predictor (:26-297).

The serving forward is the 304² ResnestUNet eval forward in bf16 with the
batch-norm stats folded into an affine and, by default, the fused decoder
epilogue kernel at every gated depth. Requests arrive as uint8 (B,H,W,3)
and are normalised on the device; results leave as float32 / float16
probabilities or a uint8 vessel mask.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.ops.norm import fold_batch_stats, folded_inference
from octave_tpu_torch.utils.convert import load_reference_state_dict

OUTPUT_FORMATS = ("prob_f32", "prob_f16", "mask_u8")


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device(device); raises if it names CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device


class Predictor:
    """Batched OCTA vessel predictor around ResnestUNet.predict."""

    def __init__(
        self,
        state_dict: Mapping[str, Any],
        num_classes: int = 2,
        method: str = "softmax",
        dtype: torch.dtype = torch.bfloat16,
        use_fused_decoder: bool = True,
        fold_bn: bool = True,
        output_format: str = "prob_f32",
        device: str | torch.device = "cuda",
    ):
        """state_dict: reference-named weights with raw BN stats (e.g. from
        `utils.convert.from_jax_variables`). fold_bn folds the stats in
        float32 before the cast to `dtype`, as the JAX Predictor does.
        use_fused_decoder=False runs the AAG kernel after each plain decoder
        block instead of the fused decoder epilogue."""
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"output_format must be one of {OUTPUT_FORMATS}; "
                             f"got {output_format!r}")
        self.device = resolve_device(device)
        self.method = method
        self.dtype = dtype
        self.output_format = output_format
        if fold_bn:
            state_dict = fold_batch_stats(
                {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in state_dict.items()})
        model = ResnestUNet(num_classes, use_fused_decoder=use_fused_decoder)
        load_reference_state_dict(model, state_dict)
        folded_inference(model, fold_bn)
        self.model = model.to(self.device, dtype).to(memory_format=torch.channels_last).eval()

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        """Device forward of one (B,H,W,3) batch already on the device."""
        if batch.dtype == torch.uint8:
            batch = batch.to(self.dtype) / 255.0  # uint8 wire format, normalised here
        _, pred = self.model.predict(batch, self.method)
        if self.output_format == "mask_u8":
            vessel = pred[..., 1] if pred.shape[-1] > 1 else pred[..., 0]
            return (vessel >= 0.5).to(torch.uint8) * 255
        if self.output_format == "prob_f16":
            return pred.to(torch.float16)
        return pred.to(torch.float32)

    def _put(self, batch: np.ndarray) -> torch.Tensor:
        # uint8 stays uint8 on the wire; floats go up in the compute dtype
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if t.dtype != torch.uint8:
            t = t.to(self.dtype)
        return t.to(self.device)

    @torch.inference_mode()
    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """(B,H,W,3) uint8 or float in [0,1] -> (B,H,W,K) probabilities, or
        a (B,H,W) uint8 mask for output_format='mask_u8'."""
        return self._forward(self._put(batch)).cpu().numpy()

    @torch.inference_mode()
    def predict_many(self, stack: np.ndarray) -> np.ndarray:
        """A (k,B,H,W,3) stack of batches: one upload, k forwards in order,
        one download."""
        xs = self._put(stack)
        return torch.stack([self._forward(xs[i]) for i in range(xs.shape[0])]).cpu().numpy()
