"""synapseml_torch — the PyTorch/CUDA port of ``synapseml_tpu``.

The JAX package stays the reference; this package grows beside it slice by
slice, mirroring its layout so each file names its counterpart:
  core/        DataFrame, params, pipeline API, stage telemetry, bucketing,
               metrics registry, retry policy
  data/        sharded sources, the prefetching DataLoader, iterator state
  parallel/    token-sequence padding (the rest with the multi-GPU slice)
  ops/         hand-written CUDA kernels (``csrc/``) with plain versions
  image/       image preprocessing stages on the host (ImageTransformer,
               augmenter, unroll, superpixels)
  models/      BERT, ViT and ResNet nets, the Flax weight bridge, the
               single-device trainer (BatchNorm state included),
               DeepTextClassifier / DeepTextModel and DeepVisionClassifier /
               DeepVisionModel
  gbdt/        LightGBM-style GBDT training and scoring, with the CUDA
               level-histogram kernel
  onnx/        the ONNX wire codec, the converter to torch ops,
               ONNXModel batch scoring, ImageFeaturizer and the ONNXHub
               model-zoo client

It imports torch and numpy, never JAX. Entry points run on the CUDA card
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    DataFrame,
    Estimator,
    GlobalParams,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
    load_stage,
)
