"""ONNX inference on the card: the wire codec, the converter to torch ops,
the batch-scoring stage and the model-zoo client.

Counterpart of ``synapseml_tpu/onnx``: :mod:`proto` decodes and encodes
model bytes (no ``onnx`` package), :mod:`convert` runs the graph as torch
ops on one device, :mod:`model` is ``ONNXModel``, :mod:`hub` is
``ONNXHub``, :mod:`featurizer` is ``ImageFeaturizer`` (this package's
``image.ImageTransformer`` in front of a sliced ``ONNXModel``). The
``com.microsoft`` contrib ops wait for ROADMAP.md queue A item 6.
"""

from .convert import ConvertedModel, convert_graph
from .featurizer import ImageFeaturizer
from .hub import ONNXHub
from .model import ONNXModel, slice_model_at_outputs
from .proto import (
    AttributeProto,
    GraphProto,
    ModelProto,
    NodeProto,
    OperatorSetId,
    TensorProto,
    ValueInfoProto,
    encode_model,
    numpy_to_tensor,
    parse_model,
    tensor_to_numpy,
)

__all__ = [
    "ONNXModel", "ONNXHub", "ImageFeaturizer", "ConvertedModel", "convert_graph",
    "slice_model_at_outputs", "ModelProto", "GraphProto", "NodeProto",
    "TensorProto", "AttributeProto", "ValueInfoProto", "OperatorSetId",
    "parse_model", "encode_model", "numpy_to_tensor", "tensor_to_numpy",
]
