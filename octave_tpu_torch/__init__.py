"""octave_tpu_torch: the OCTAve segmentor in PyTorch for NVIDIA Hopper GPUs.

A port of `octave_tpu` (JAX) that keeps its module layout. Plain tensor code
is PyTorch; the two Pallas TPU kernels of the serving forward are Triton
kernels here (`ops/kernels/`). Entry points run on CUDA unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Layout (JAX counterpart in brackets):
  * ops/common.py, ops/norm.py       [octave_tpu/ops/common.py, norm.py]
  * ops/kernels/aag.py               [octave_tpu/ops/pallas/aag.py]
  * ops/kernels/decoder_epilogue.py  [octave_tpu/ops/pallas/decoder_epilogue.py]
  * models/resnest.py, segmentor.py  [octave_tpu/models/resnest.py, segmentor.py]
  * utils/checkpoint.py              [octave_tpu/utils/checkpoint.py, npz part]
  * utils/convert.py                 [inverse of octave_tpu/utils/torch_convert.py]
  * serve.py                         [octave_tpu/serve.py::Predictor]
"""

__version__ = "0.1.0"
