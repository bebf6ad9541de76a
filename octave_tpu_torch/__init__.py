"""octave_tpu_torch: the OCTAve segmentor in PyTorch for NVIDIA Hopper GPUs.

A port of `octave_tpu` (JAX) that keeps its module layout. Plain tensor code
is PyTorch; the two Pallas TPU kernels are Triton kernels here
(`ops/kernels/`). Entry points run on CUDA unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Layout (JAX counterpart in brackets):
  * ops/common.py, ops/norm.py       [octave_tpu/ops/common.py, norm.py; norm.py
                                      also the cross-replica statistics]
  * ops/quant.py                     [octave_tpu/ops/quant.py: int8 PTQ serving]
  * ops/kernels/aag.py               [octave_tpu/ops/pallas/aag.py]
  * ops/kernels/decoder_epilogue.py  [octave_tpu/ops/pallas/decoder_epilogue.py]
  * models/resnest.py, segmentor.py  [octave_tpu/models/resnest.py, segmentor.py]
  * models/propagation.py, octa.py   [octave_tpu/models/propagation.py, octa.py]
  * models/discriminator.py          [octave_tpu/models/discriminator.py]
  * losses/gan.py, segmentor.py      [octave_tpu/losses/gan.py, segmentor.py]
  * data/datasets.py, preprocess.py, [octave_tpu/data/datasets.py, preprocess.py,
    augment.py                        augment.py]
  * data/native.py, data/_native/    [octave_tpu/data/native.py, _native/loader.cpp;
    loader.cpp                        the port's own copy, with TIFF]
  * parallel/ddp.py                  [octave_tpu/parallel/mesh.py, on torch.distributed]
  * parallel/mesh.py                 [octave_tpu/parallel/mesh.py: the serving mesh]
  * train/schedule.py, state.py,     [octave_tpu/train/...]
    steps.py, trainer.py
  * utils/config.py, metrics.py,     [octave_tpu/utils/config.py, metrics.py,
    logging.py                        logging.py + profiling.py::StepTimer]
  * utils/checkpoint.py              [octave_tpu/utils/checkpoint.py, npz part]
  * utils/convert.py                 [inverse of octave_tpu/utils/torch_convert.py]
  * utils/padding.py                 [octave_tpu/utils/padding.py]
  * utils/profiling.py               [octave_tpu/utils/profiling.py::trace; the
                                      port's spans, set-up phases and counters]
  * serve.py                         [octave_tpu/serve.py::Predictor, BatchServer]
  * cli.py                           [octave_tpu/cli.py: train, eval, predict, convert,
                                      bench]
  * bench.py                         [bench.py at the repository's root]

The package's top level names its main entry points lazily, as the JAX
package's does: `octave_tpu_torch.Predictor` imports `serve` on first use.
`models` and `losses` re-export the JAX package's public names.
"""

__version__ = "0.1.0"

_LAZY = {
    "OctaScribbleNet": ("octave_tpu_torch.models.octa", "OctaScribbleNet"),
    "octa_scribble_net": ("octave_tpu_torch.models.octa", "octa_scribble_net"),
    "ResnestUNet": ("octave_tpu_torch.models.segmentor", "ResnestUNet"),
    "DiscriminatorBlock": ("octave_tpu_torch.models.discriminator", "DiscriminatorBlock"),
    "Trainer": ("octave_tpu_torch.train.trainer", "Trainer"),
    "Config": ("octave_tpu_torch.utils.config", "Config"),
    "Predictor": ("octave_tpu_torch.serve", "Predictor"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'octave_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
