"""synapseml_torch — the PyTorch/CUDA port of ``synapseml_tpu``.

The JAX package stays the reference; this package grows beside it slice by
slice, mirroring its layout so each file names its counterpart:
  core/        DataFrame, params, pipeline API, stage telemetry, bucketing,
               the callable cache and its provider tier, metrics registry
               with Prometheus exposition, trace spans with traceparent
               and Chrome export, retry policy, circuit breaker, deadlines,
               seeded fault injection
  data/        sharded sources (in memory, and jsonl/csv/npy/image files),
               the prefetching DataLoader, iterator state
  io/          HTTP model serving (serve_pipeline, serve_llm, hot swap by
               path or registry), the sources' path resolvers and JSONL
               line parser
  registry/    content-addressed artifact store, versioned publish/resolve
               with aliases, the warmup-only AOT contract, autotuning
  parallel/    the mesh of the process group, partition rules, collectives,
               checkpoints and resume, the rendezvous, training batchers
  ops/         hand-written CUDA kernels (``csrc/``) with plain versions;
               ring and Ulysses attention
  image/       image preprocessing stages on the host (ImageTransformer,
               augmenter, unroll, superpixels)
  models/      BERT, ViT, ResNet and Llama nets, the Flax weight bridge, the
               trainer (on a mesh too; BatchNorm state included),
               DeepTextClassifier / DeepTextModel and DeepVisionClassifier /
               DeepVisionModel
  gbdt/        LightGBM-style GBDT training and scoring (every boosting mode,
               categorical splits, the ranker, model.txt interop,
               out-of-core training), with the CUDA level-histogram kernel
  onnx/        the ONNX wire codec, the converter to torch ops,
               ONNXModel batch scoring, ImageFeaturizer and the ONNXHub
               model-zoo client
  hf/          HuggingFaceCausalLM: Llama batch generation through the
               dense KV-cache decode or the paged decode engine
               (models/paged_engine.py, models/prefix_cache.py), and its
               serving engine for serve_llm

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
