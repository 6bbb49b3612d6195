"""synapseml_torch.onnx against the JAX package's onnx module.

The same model bytes and the same numpy inputs from a seed go through the
JAX converter and stage and through the port's, on the CPU: the wire codec
byte for byte, every ported op on single-node graphs written with the
port's writer (within 1e-5 in f32), real torch exports of a small ResNet
and of a 2-layer BERT encoder (within 1e-5 of the JAX converter, 2e-4 of
the torch module), and ``ONNXModel.transform`` with partial rungs, an
empty partition, softmax and argmax columns and ``slice_at_outputs``
(within 1e-5, the same columns, dtypes and empty-partition shapes), and
``ImageFeaturizer`` on ragged images, headless at the ResNet's Flatten
output and whole (within 1e-5, the same columns). Where
the port follows the ONNX spec past the reference (``ceil_mode``,
LayerNormalization over ``[axis, rank)``, several negative Unsqueeze axes)
it is held to torch or numpy instead.
"""

import hashlib
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (before the exporters' spec-less onnx stand-in)
import torch.nn.functional as F

import synapseml_torch as pt
from synapseml_torch.core import batching as tcb
from synapseml_torch.onnx import ONNXHub, ONNXModel, convert_graph, slice_model_at_outputs
from synapseml_torch.onnx import proto as P
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.onnx import ONNXModel as JONNXModel
from synapseml_tpu.onnx import convert_graph as jconvert_graph
from synapseml_tpu.onnx import slice_model_at_outputs as jslice_model_at_outputs
from synapseml_tpu.onnx import proto as JP

sys.path.insert(0, str(Path(__file__).parent))
from _torch_bert import TorchBertEncoder, export_bert_onnx_bytes  # noqa: E402
from _torch_resnet import export_onnx_bytes, resnet_small  # noqa: E402

TOL = 1e-5
I64 = np.int64


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(*shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _model_bytes(op, inputs, attrs=None, n_out=1, init=()):
    """A one-node model written with the port's writer: ``inputs[i]`` is an
    initializer when ``i`` is in ``init`` (the exporters' host shape
    constants), a graph input otherwise; None is an omitted input."""
    names = [f"in{i}" if a is not None else "" for i, a in enumerate(inputs)]
    node = P.NodeProto(input=names, output=[f"out{j}" for j in range(n_out)], op_type=op,
                       attribute=[P.AttributeProto.make(k, v) for k, v in (attrs or {}).items()])
    present = [(i, n, np.asarray(a)) for i, (n, a) in enumerate(zip(names, inputs))
               if a is not None]
    g = P.GraphProto(
        name=op, node=[node],
        initializer=[P.numpy_to_tensor(a, n) for i, n, a in present if i in init],
        input=[P.ValueInfoProto(name=n, elem_type=P._NP_TO_DTYPE[a.dtype], dims=list(a.shape))
               for i, n, a in present if i not in init],
        output=[P.ValueInfoProto(name=f"out{j}") for j in range(n_out)])
    feeds = {n: a for i, n, a in present if i not in init}
    return P.ModelProto(graph=g).encode(), feeds


def _port(data, feeds):
    return {k: v.numpy() for k, v in convert_graph(data).run(feeds, "cpu").items()}


def _jax(data, feeds):
    return {k: np.asarray(v) for k, v in jconvert_graph(data)(**feeds).items()}


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

def _hand_built_model() -> bytes:
    sub = P.GraphProto(name="branch", node=[P.NodeProto(input=["a"], output=["b"],
                                                        op_type="Relu")],
                       output=[P.ValueInfoProto(name="b")])
    attrs = dict(f=0.5, i=-3, s="SAME_UPPER", t=_f32(2, 3), floats=[1.0, -2.5],
                 ints=[0, -1, 2 ** 40], strings=["x", "yz"], g=sub)
    node = P.NodeProto(input=["x", "w"], output=["y"], name="n0", op_type="Custom",
                       domain="com.example",
                       attribute=[P.AttributeProto.make(k, v) for k, v in attrs.items()])
    inits = [P.numpy_to_tensor(_f32(3, 4, seed=1), "w"),
             P.numpy_to_tensor(np.array([np.iinfo(I64).max, np.iinfo(I64).min], I64), "ends"),
             P.TensorProto(dims=[2], data_type=P.FLOAT, float_data=[1.5, -2.0], name="fd"),
             P.TensorProto(dims=[2], data_type=P.INT64, int64_data=[-1, 7], name="i64"),
             P.TensorProto(dims=[1], data_type=P.DOUBLE, double_data=[0.25], name="dd"),
             P.TensorProto(dims=[2], data_type=P.FLOAT16, int32_data=[15360, 14336],
                           name="h")]
    g = P.GraphProto(node=[node], name="hand", initializer=inits,
                     input=[P.ValueInfoProto(name="x", elem_type=P.FLOAT, dims=["N", 3])],
                     output=[P.ValueInfoProto(name="y", dims=["N", 4])],
                     value_info=[P.ValueInfoProto(name="mid", dims=[None, 2])])
    return P.ModelProto(ir_version=9, producer_name="test", graph=g,
                        opset_import=[P.OperatorSetId(version=20),
                                      P.OperatorSetId(domain="com.example", version=1)]).encode()


@pytest.fixture(scope="module")
def small_resnet():
    torch.manual_seed(1)
    model = resnet_small(num_classes=10).eval()
    return model, export_onnx_bytes(model, torch.zeros(1, 3, 32, 32))


@pytest.fixture(scope="module")
def bert_encoder():
    torch.manual_seed(0)
    model = TorchBertEncoder(vocab=512, hidden=64, heads=4, layers=2, mlp=128, max_len=128,
                             num_classes=3)
    ids = torch.randint(0, 512, (2, 16))
    mask = torch.ones(2, 16, dtype=torch.long)
    mask[1, 10:] = 0
    return model, export_bert_onnx_bytes(model, ids, mask)


def test_codec_bytes_equal_the_jax_codecs_for_a_hand_built_model():
    data = _hand_built_model()
    assert JP.parse_model(data).encode() == data
    assert P.parse_model(data).encode() == data
    assert P.encode_model(P.parse_model(data)) == JP.encode_model(JP.parse_model(data))


@pytest.mark.parametrize("which", ["resnet", "bert"])
def test_codec_bytes_equal_the_jax_codecs_for_an_export(which, small_resnet, bert_encoder):
    data = (small_resnet if which == "resnet" else bert_encoder)[1]
    ours = P.encode_model(P.parse_model(data))
    assert ours == JP.encode_model(JP.parse_model(data))
    theirs = JP.parse_model(data)
    for a, b in zip(P.parse_model(data).graph.initializer, theirs.graph.initializer):
        np.testing.assert_array_equal(P.tensor_to_numpy(a), JP.tensor_to_numpy(b))


def test_float16_bfloat16_bits_and_int64_sentinels_decode_as_the_jax_codec():
    bf = np.array([1.0, -2.5, 0.125], ml_dtypes.bfloat16)
    bits = bf.view(np.uint16)
    tensors = [
        P.TensorProto(dims=[2], data_type=P.FLOAT16, int32_data=[15360, 14336]),
        P.TensorProto(dims=[3], data_type=P.BFLOAT16, raw_data=bf.tobytes()),
        P.TensorProto(dims=[3], data_type=P.BFLOAT16, int32_data=[int(b) for b in bits]),
        P.TensorProto(dims=[2], data_type=P.INT64,
                      int64_data=[np.iinfo(I64).max, np.iinfo(I64).min]),
        P.numpy_to_tensor(np.array([2 ** 31 + 7, -1], I64)),
    ]
    for t in tensors:
        ours = P.tensor_to_numpy(P.TensorProto.parse(t.encode()))
        theirs = JP.tensor_to_numpy(JP.TensorProto.parse(t.encode()))
        if t.data_type == P.BFLOAT16:  # the port keeps bfloat16 as its bits
            assert ours.dtype == np.uint16
            np.testing.assert_array_equal(ours, theirs.view(np.uint16))
        else:
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(P.tensor_to_numpy(tensors[0]), np.array([1.0, 0.5], np.float16))
    # the writer takes a bfloat16 array and writes what JAX does
    assert P.numpy_to_tensor(bf, "b").encode() == JP.numpy_to_tensor(bf, "b").encode()
    assert P.tensor_to_numpy(P.numpy_to_tensor(bf)).tobytes() == bits.tobytes()


# ---------------------------------------------------------------------------
# single-node graphs, port against the JAX converter
# ---------------------------------------------------------------------------

def _c(op, inputs, attrs=None, init=(), n_out=1, id=None):
    return pytest.param(op, inputs, attrs or {}, init, n_out, id=id or op)


_X4 = _f32(2, 4, 9, 9)
_NEG = -np.abs(_f32(1, 2, 5, 6, seed=3)) - 1.0  # all below 0: a zero pad would win a max
_BIG = np.iinfo(I64).max
OP_CASES = [
    # convolutions (OIHW weights)
    _c("Conv", [_X4, _f32(6, 4, 3, 3, seed=1), _f32(6, seed=2)],
       dict(strides=[2, 2], pads=[1, 1, 1, 1]), init=(1, 2), id="conv-stride-pad-bias"),
    _c("Conv", [_X4, _f32(3, 4, 3, 3, seed=1)], dict(dilations=[2, 2]), init=(1,),
       id="conv-dilation"),
    _c("Conv", [_X4, _f32(6, 2, 3, 3, seed=1)], dict(group=2, pads=[1, 1, 1, 1]), init=(1,),
       id="conv-groups"),
    _c("Conv", [_X4, _f32(3, 4, 4, 4, seed=1)], dict(strides=[2, 2], auto_pad="SAME_UPPER"),
       init=(1,), id="conv-same-upper"),
    _c("Conv", [_X4, _f32(3, 4, 4, 4, seed=1)], dict(strides=[2, 2], auto_pad="SAME_LOWER"),
       init=(1,), id="conv-same-lower"),
    _c("Conv", [_X4, _f32(3, 4, 3, 2, seed=1)], dict(dilations=[2, 1], auto_pad="SAME_UPPER"),
       init=(1,), id="conv-same-dilated"),
    _c("Conv", [_X4, _f32(3, 4, 3, 3, seed=1)], dict(strides=[2, 2], auto_pad="VALID"),
       init=(1,), id="conv-valid"),
    _c("Conv", [_X4, _f32(3, 4, 3, 3, seed=1)], dict(pads=[0, 1, 2, 0]), init=(1,),
       id="conv-asymmetric-pads"),
    _c("Conv", [_f32(2, 3, 11), _f32(4, 3, 3, seed=1), _f32(4, seed=2)],
       dict(strides=[2], pads=[1, 1]), init=(1, 2), id="conv-1d"),
    # pooling
    _c("MaxPool", [_X4], dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
       id="maxpool-resnet-stem"),
    _c("MaxPool", [_NEG], dict(kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 1, 0]),
       id="maxpool-asymmetric-pads-negative"),
    _c("MaxPool", [_NEG], dict(kernel_shape=[2, 2], strides=[2, 2], pads=[1, 1, 1, 1]),
       id="maxpool-wide-pads-negative"),
    _c("MaxPool", [_NEG[:, :, :5, :5]],
       dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1], ceil_mode=1),
       id="maxpool-ceil-mode-same-shape"),
    _c("MaxPool", [_X4], dict(kernel_shape=[2, 2], strides=[2, 2], auto_pad="SAME_LOWER"),
       id="maxpool-same-lower"),
    _c("AveragePool", [_X4], dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
       id="avgpool-exclude-pad"),
    _c("AveragePool", [_X4], dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 2],
                                  count_include_pad=1), id="avgpool-include-pad"),
    _c("AveragePool", [_X4], dict(kernel_shape=[2, 3], auto_pad="SAME_UPPER"),
       id="avgpool-same-upper"),
    _c("GlobalAveragePool", [_X4]),
    _c("GlobalMaxPool", [_X4]),
    # linear algebra and normalization
    _c("Gemm", [_f32(5, 3), _f32(4, 5, seed=1), _f32(4, seed=2)],
       dict(transA=1, transB=1, alpha=0.5, beta=2.0), init=(1, 2), id="gemm-trans-alpha-beta"),
    _c("Gemm", [_f32(3, 5), _f32(5, 4, seed=1), _f32(1, 4, seed=2)], init=(1, 2),
       id="gemm-row-bias"),
    _c("Gemm", [_f32(3, 5), _f32(5, 4, seed=1), _f32(3, 1, seed=2)], dict(beta=-1.0),
       id="gemm-column-bias"),
    _c("MatMul", [_f32(2, 1, 3, 5), _f32(4, 5, 2, seed=1)], id="matmul-broadcast"),
    _c("Einsum", [_f32(2, 5, 3, 4), _f32(2, 6, 3, 4, seed=1)],
       dict(equation="bthd,bshd->bhts")),
    _c("BatchNormalization", [_X4, *(_f32(4, seed=s) for s in (1, 2, 3)),
                              np.abs(_f32(4, seed=4)) + 0.5], dict(epsilon=1e-3),
       init=(1, 2, 3, 4)),
    _c("LayerNormalization", [_f32(2, 3, 8), _f32(8, seed=1), _f32(8, seed=2)],
       dict(epsilon=1e-5), init=(1, 2)),
    # elementwise
    _c("Add", [_f32(2, 3, 4), _f32(3, 1, seed=1)], id="add-broadcast"),
    _c("Sub", [_f32(2, 3), np.float32(1.5)], init=(1,), id="sub-scalar-initializer"),
    _c("Mul", [_f32(2, 3), _f32(2, 3, seed=1)]),
    _c("Div", [_f32(2, 3), np.abs(_f32(3, seed=1)) + 0.5], id="div-float"),
    _c("Div", [np.array([7, -7, 7, -7, 6], np.int32), np.array([2, 2, -2, -2, 3], np.int32)],
       id="div-int-truncates"),
    _c("Pow", [np.abs(_f32(2, 3)), np.float32(1.7)], init=(1,)),
    *(_c(o, [_f32(3, 4)]) for o in ("Neg", "Abs", "Exp", "Erf", "Relu", "Sigmoid", "Tanh",
                                     "Sin", "Cos", "HardSwish", "Identity", "Dropout")),
    *(_c(o, [np.abs(_f32(3, 4)) + 0.1]) for o in ("Sqrt", "Log")),
    _c("LeakyRelu", [_f32(3, 4)], dict(alpha=0.2)),
    _c("Gelu", [_f32(3, 4)], id="gelu-erf"),
    _c("Gelu", [_f32(3, 4)], dict(approximate="tanh"), id="gelu-tanh"),
    _c("HardSigmoid", [_f32(3, 4)], dict(alpha=0.3, beta=0.4)),
    _c("Softmax", [_f32(2, 3, 5)], dict(axis=1)),
    _c("LogSoftmax", [_f32(2, 3, 5)]),
    _c("Clip", [_f32(3, 4), np.float32(-0.5), np.float32(0.5)], init=(1, 2), id="clip-inputs"),
    _c("Clip", [_f32(3, 4), None, np.float32(0.2)], init=(2,), id="clip-max-only"),
    _c("Where", [_f32(3, 4) > 0, _f32(3, 4, seed=1), _f32(4, seed=2)]),
    _c("Equal", [np.array([1, 2, 3], I64), np.array([1, 0, 3], I64)]),
    _c("Greater", [_f32(3, 4), _f32(4, seed=1)]),
    _c("Less", [_f32(3, 4), _f32(4, seed=1)]),
    _c("Not", [_f32(3, 4) > 0]),
    # shape and structure
    _c("Reshape", [_f32(2, 3, 4), np.array([0, -1], I64)], init=(1,), id="reshape-copy-infer"),
    _c("Flatten", [_f32(2, 3, 4)], dict(axis=-1), id="flatten-negative-axis"),
    _c("Flatten", [_f32(2, 3, 4)], dict(axis=0), id="flatten-axis-0"),
    _c("Flatten", [_f32(2, 3, 4)], id="flatten-default"),
    _c("Transpose", [_f32(2, 3, 4)], dict(perm=[2, 0, 1])),
    _c("Transpose", [_f32(2, 3, 4)], id="transpose-reversed"),
    _c("Concat", [_f32(2, 3), _f32(2, 1, seed=1)], dict(axis=-1)),
    _c("Split", [_f32(2, 7), np.array([3, 4], I64)], dict(axis=1), init=(1,), n_out=2,
       id="split-sizes"),
    _c("Split", [_f32(6, 2)], dict(num_outputs=3), n_out=3, id="split-num-outputs"),
    _c("Squeeze", [_f32(2, 1, 3, 1), np.array([1, -1], I64)], init=(1,)),
    _c("Unsqueeze", [_f32(2, 3), np.array([-1], I64)], init=(1,)),
    _c("Unsqueeze", [_f32(2, 3), np.array([0, 2], I64)], init=(1,), id="unsqueeze-two"),
    _c("Slice", [_f32(6, 5), np.array([1, -4], I64), np.array([_BIG, -1], I64),
                 np.array([0, 1], I64), np.array([2, 1], I64)], init=(1, 2, 3, 4),
       id="slice-steps-and-sentinel"),
    _c("Slice", [_f32(6, 5), np.array([4], I64), np.array([np.iinfo(I64).min], I64),
                 np.array([-2], I64), np.array([-2], I64)], init=(1, 2, 3, 4),
       id="slice-negative-step-to-start"),
    _c("Gather", [_f32(5, 4), np.array([[0, -1], [3, 1]], I64)], dict(axis=0), init=(1,),
       id="gather-negative-indices"),
    _c("Gather", [_f32(2, 5, 3), np.array(2, I64)], dict(axis=1), init=(1,),
       id="gather-scalar-index"),
    _c("Expand", [_f32(3, 1), np.array([2, 1, 4], I64)], init=(1,)),
    _c("Pad", [_f32(2, 3), np.array([0, 1, 1, 2], I64), np.float32(-3.0)], init=(1, 2),
       id="pad-constant"),
    _c("Pad", [_f32(1, 2, 4, 5), np.array([0, 0, 1, 2, 0, 0, 2, 1], I64)],
       dict(mode="reflect"), init=(1,), id="pad-reflect"),
    _c("Pad", [_f32(1, 2, 4, 5), np.array([0, 0, 1, 2, 0, 0, 2, 1], I64)],
       dict(mode="edge"), init=(1,), id="pad-edge"),
    _c("Cast", [_f32(3, 4) * 5], dict(to=P.INT32), id="cast-to-int32"),
    _c("Cast", [np.array([1, 0, 3], I64)], dict(to=P.FLOAT), id="cast-to-float"),
    _c("Shape", [_f32(2, 3, 4)]),
    _c("ConstantOfShape", [np.array([2, 3], I64)], dict(value=np.array([1.5], np.float32)),
       init=(0,), id="constant-of-shape-float"),
    _c("ConstantOfShape", [np.array([4], I64)], dict(value=np.array([-1], I64)), init=(0,),
       id="constant-of-shape-int64"),
    _c("Range", [np.array(2, I64), np.array(11, I64), np.array(3, I64)], init=(0, 1, 2)),
    _c("Constant", [], dict(value=_f32(2, 3))),
    _c("Constant", [], dict(value_ints=[3, -1]), id="constant-ints"),
    # reductions and selection
    _c("ReduceMean", [_f32(2, 3, 4)], dict(axes=[1, 2])),
    _c("ReduceSum", [_f32(2, 3, 4), np.array([-1], I64)], dict(keepdims=0), init=(1,)),
    _c("ReduceMax", [_f32(2, 3, 4)]),
    _c("ReduceMin", [_f32(2, 3, 4)], dict(axes=[0], keepdims=0)),
    _c("ReduceProd", [_f32(2, 3, 4)], dict(axes=[0, 2])),
    _c("ReduceSum", [_f32(2, 3), np.zeros(0, I64)], dict(noop_with_empty_axes=1), init=(1,),
       id="reduce-noop-empty-axes"),
    _c("TopK", [_f32(3, 7), np.array([3], I64)], dict(axis=1), init=(1,), n_out=2,
       id="topk-largest"),
    _c("TopK", [_f32(6, 2), np.array([2], I64)], dict(axis=0, largest=0), init=(1,), n_out=2,
       id="topk-smallest"),
    _c("ArgMax", [_f32(3, 7)], dict(axis=1, keepdims=0)),
    _c("ArgMax", [_f32(3, 7)], id="argmax-keepdims"),
    _c("Tile", [_f32(2, 3), np.array([2, 1], I64)], init=(1,)),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out", OP_CASES)
def test_op_matches_jax(op, inputs, attrs, init, n_out):
    data, feeds = _model_bytes(op, inputs, attrs, n_out, init)
    ours, theirs = _port(data, feeds), _jax(data, feeds)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        # index outputs (TopK, ArgMax) are int64 here, as ONNX says; int32 there
        np.testing.assert_allclose(ours[k].astype(np.float64), theirs[k].astype(np.float64),
                                   rtol=TOL, atol=TOL, err_msg=f"{op} {k}")


def test_slice_sentinel_survives_concat_cast_chain():
    """INT64_MAX "to the end" built through Unsqueeze/Cast/Concat of int64
    constants stays host numpy and never wraps."""
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    inits = {"e0": np.array(_BIG, I64), "zero": np.array([0], I64), "st": np.array([1], I64),
             "ax": np.array([0], I64), "sp": np.array([1], I64)}
    nodes = [P.NodeProto(input=["e0", "zero"], output=["e0u"], op_type="Unsqueeze"),
             P.NodeProto(input=["e0u"], output=["e0c"], op_type="Cast",
                         attribute=[P.AttributeProto.make("to", P.INT64)]),
             P.NodeProto(input=["e0c"], output=["ends"], op_type="Concat",
                         attribute=[P.AttributeProto.make("axis", 0)]),
             P.NodeProto(input=["x", "st", "ends", "ax", "sp"], output=["y"], op_type="Slice")]
    g = P.GraphProto(node=nodes, initializer=[P.numpy_to_tensor(v, k) for k, v in inits.items()],
                     input=[P.ValueInfoProto(name="x", dims=[4, 5])],
                     output=[P.ValueInfoProto(name="y")])
    data = P.ModelProto(graph=g).encode()
    np.testing.assert_array_equal(_port(data, {"x": x})["y"], x[1:])
    np.testing.assert_array_equal(_port(data, {"x": x})["y"], _jax(data, {"x": x})["y"])


def test_spec_semantics_past_the_reference():
    """ceil_mode that changes the output shape against torch's own pooling;
    LayerNormalization over [axis, rank); Unsqueeze with two negative axes
    counted from the output's end."""
    x = _f32(1, 2, 6, 7)
    data, feeds = _model_bytes("MaxPool", [x], dict(kernel_shape=[3, 3], strides=[2, 2],
                                                    pads=[1, 1, 1, 1], ceil_mode=1))
    want = F.max_pool2d(torch.from_numpy(x), 3, 2, 1, ceil_mode=True).numpy()
    got = _port(data, feeds)["out0"]
    assert got.shape == want.shape == (1, 2, 4, 4)
    np.testing.assert_array_equal(got, want)
    data, feeds = _model_bytes("AveragePool", [x], dict(kernel_shape=[3, 3], strides=[2, 2],
                                                        pads=[1, 1, 1, 1], ceil_mode=1))
    want = F.avg_pool2d(torch.from_numpy(x), 3, 2, 1, ceil_mode=True,
                        count_include_pad=False).numpy()
    np.testing.assert_allclose(_port(data, feeds)["out0"], want, rtol=TOL, atol=TOL)

    x = _f32(2, 3, 4)
    data, feeds = _model_bytes("LayerNormalization", [x], dict(axis=-2, epsilon=1e-5))
    mu = x.mean(axis=(1, 2), keepdims=True)
    want = (x - mu) / np.sqrt(x.var(axis=(1, 2), keepdims=True) + 1e-5)
    np.testing.assert_allclose(_port(data, feeds)["out0"], want, rtol=TOL, atol=TOL)

    data, feeds = _model_bytes("Unsqueeze", [_f32(3), np.array([-1, -2], I64)], init=(1,))
    assert _port(data, feeds)["out0"].shape == (3, 1, 1)


def test_unsupported_ops_raise_at_conversion_with_their_roadmap_item():
    for op in ("NonexistentOp", "Trilu", "Loop"):
        data, _ = _model_bytes(op, [_f32(2)])
        with pytest.raises(NotImplementedError, match=f"{op}.*queue A item 6"):
            convert_graph(data)
    # an op inside a subgraph is found too
    sub = P.GraphProto(node=[P.NodeProto(input=["a"], output=["b"], op_type="Resize")])
    node = P.NodeProto(input=["c"], output=["y"], op_type="If",
                       attribute=[P.AttributeProto.make("then_branch", sub),
                                  P.AttributeProto.make("else_branch", sub)])
    data = P.ModelProto(graph=P.GraphProto(node=[node], input=[P.ValueInfoProto(name="c")],
                                           output=[P.ValueInfoProto(name="y")])).encode()
    with pytest.raises(NotImplementedError, match=r"\['If', 'Resize'\]"):
        convert_graph(data)


# ---------------------------------------------------------------------------
# real exports
# ---------------------------------------------------------------------------

def test_resnet_small_export_matches_jax_and_torch(small_resnet):
    model, data = small_resnet
    x = _rng(0).normal(size=(5, 3, 32, 32)).astype(np.float32)
    ours = _port(data, {"input": x})["logits"]
    np.testing.assert_allclose(ours, _jax(data, {"input": x})["logits"], rtol=TOL, atol=TOL)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, want, atol=2e-4)


def test_bert_encoder_export_matches_jax_and_torch(bert_encoder):
    model, data = bert_encoder
    ops = {n.op_type for n in P.parse_model(data).graph.node}
    assert {"Einsum", "LayerNormalization", "Shape", "Gather", "Range", "Erf"} <= ops
    for B, T, pad in ((2, 16, 6), (3, 24, 0)):
        g = torch.Generator().manual_seed(B * 100 + T)
        ids = torch.randint(0, 512, (B, T), generator=g)
        mask = torch.ones(B, T, dtype=torch.long)
        if pad:
            mask[-1, -pad:] = 0
        feeds = {"input_ids": ids.numpy(), "attention_mask": mask.numpy()}
        ours = _port(data, feeds)["logits"]
        np.testing.assert_allclose(ours, _jax(data, feeds)["logits"], rtol=TOL, atol=TOL)
        with torch.no_grad():
            want = model(ids, mask).numpy()
        np.testing.assert_allclose(ours, want, rtol=2e-4, atol=2e-5)


def test_weights_move_to_a_device_once(small_resnet):
    conv = convert_graph(small_resnet[1])
    first = conv.weights_on("cpu")
    x = _f32(2, 3, 32, 32)
    conv.run({"input": x}, "cpu")
    assert conv.weights_on("cpu") is first
    assert all(isinstance(v, torch.Tensor) for v in first.values())


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

def _parts(x, sizes):
    """Partitions of ``sizes`` rows (0 = an empty partition)."""
    out, at = [], 0
    for n in sizes:
        out.append({"img": x[at:at + n], "row": np.arange(at, at + n)})
        at += n
    return out


STAGE = dict(mini_batch_size=8, feed_dict={"input": "img"}, fetch_dict={"logits": "logits"},
             softmax_dict={"logits": "probs"}, argmax_dict={"logits": "prediction"})


def _stages(data, **kw):
    return ONNXModel(model_bytes=data, device="cpu", **{**STAGE, **kw}), \
        JONNXModel(model_bytes=data, **{**STAGE, **kw})


def _assert_same_frames(ours, theirs):
    assert len(ours.partitions) == len(theirs.partitions)
    for p, q in zip(ours.partitions, theirs.partitions):
        assert list(p) == list(q)
        for col in p:
            a, b = np.asarray(p[col]), np.asarray(q[col])
            assert a.shape == b.shape and a.dtype == b.dtype, (col, a.shape, b.shape, a.dtype,
                                                               b.dtype)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=col)
            else:
                np.testing.assert_array_equal(a, b, err_msg=col)


def test_transform_matches_the_jax_stage(small_resnet):
    model, data = small_resnet
    x = _f32(23, 3, 32, 32, seed=4)
    sizes = (11, 0, 7, 5)  # 8 + 3 rows, an empty partition, 7 and 5 (partial rungs)
    ours_stage, theirs_stage = _stages(data)
    ours = ours_stage.transform(pt.DataFrame(_parts(x, sizes)))
    theirs = theirs_stage.transform(JDataFrame(_parts(x, sizes)))
    _assert_same_frames(ours, theirs)
    assert ours.partitions[1]["logits"].shape == (0, 10)
    assert ours.partitions[1]["prediction"].dtype == np.int32
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.concatenate([p["logits"] for p in ours.partitions]), want,
                               atol=2e-4)


def test_transform_default_feeds_and_fetches_and_an_all_empty_frame(small_resnet):
    data = small_resnet[1]
    ours = ONNXModel(model_bytes=data, device="cpu", mini_batch_size=4)
    theirs = JONNXModel(model_bytes=data, mini_batch_size=4)
    x = _f32(6, 3, 32, 32, seed=5)
    frames = [{"features": x[:6]}], [{"features": x[:0]}]
    for parts in frames:
        _assert_same_frames(ours.transform(pt.DataFrame([dict(p) for p in parts])),
                            theirs.transform(JDataFrame([dict(p) for p in parts])))


def test_one_callable_per_rung_through_the_compiled_cache(small_resnet):
    data = small_resnet[1]
    stage = ONNXModel(model_bytes=data, device="cpu", **{**STAGE, "mini_batch_size": 32})
    cache = tcb.get_compiled_cache()
    df = pt.DataFrame(_parts(_f32(23, 3, 32, 32, seed=4), (11, 0, 7, 5)))
    before = cache.miss_count("onnx_model")
    out = stage.transform(df)
    # the ladder's rungs from 8: 11 rows pad to 16, 7 and 5 rows to 8
    assert cache.miss_count("onnx_model") - before == 2
    again = stage.transform(df)
    assert cache.miss_count("onnx_model") - before == 2
    for p, q in zip(out.partitions, again.partitions):
        for col in p:
            np.testing.assert_array_equal(p[col], q[col])
    tok = tcb.instance_token(stage)
    assert sum(1 for k in cache._entries if k[1] == tok) == 2
    stage.slice_at_outputs(["logits"])  # evicts the instance's callables
    assert not any(k[1] == tok for k in cache._entries)
    assert tcb.instance_token(stage) != tok


def test_slice_at_outputs_matches_the_jax_stage(small_resnet):
    data = small_resnet[1]
    graph = P.parse_model(data).graph
    flat = next(n.output[0] for n in graph.node if n.op_type == "Flatten")
    assert slice_model_at_outputs(data, [flat]) == jslice_model_at_outputs(data, [flat])
    kw = dict(mini_batch_size=8, feed_dict={"input": "img"}, fetch_dict={"features": flat})
    ours = ONNXModel(model_bytes=data, device="cpu", **kw)
    theirs = JONNXModel(model_bytes=data, **kw)
    x = _f32(9, 3, 32, 32, seed=6)
    ours.transform(pt.DataFrame(_parts(x, (9,))))  # a callable of the full graph first
    ours.slice_at_outputs([flat])
    theirs.slice_at_outputs([flat])
    assert ours.model_output_names == [flat]
    got = ours.transform(pt.DataFrame(_parts(x, (9,))))
    _assert_same_frames(got, theirs.transform(JDataFrame(_parts(x, (9,)))))
    assert got.partitions[0]["features"].shape == (9, 64)  # layer2's 16 * 4 channels


def test_save_load_round_trip(tmp_path, small_resnet):
    stage = ONNXModel(model_bytes=small_resnet[1], device="cpu", **STAGE)
    df = pt.DataFrame(_parts(_f32(5, 3, 32, 32, seed=7), (5,)))
    want = stage.transform(df)
    stage.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    got = loaded.transform(df)
    for col in want.partitions[0]:
        np.testing.assert_array_equal(want.partitions[0][col], got.partitions[0][col])


def test_params_match_the_jax_stage():
    ours = {k: v.default for k, v in ONNXModel.params().items()}
    theirs = {k: v.default for k, v in JONNXModel.params().items()}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    with pytest.raises(ValueError, match="device"):
        ONNXModel(device="tpu")


def test_default_device_is_the_card(small_resnet):
    """The no-device default is 'cuda'; on a host without a CUDA device it
    raises instead of scoring on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    stage = ONNXModel(model_bytes=small_resnet[1], **STAGE)
    assert stage.get("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage.transform(pt.DataFrame(_parts(_f32(2, 3, 32, 32), (2,))))


def test_converted_model_call_defaults_to_the_card(small_resnet):
    """Called with numpy inputs only, a converted graph runs on the card, so a
    host without one refuses; a tensor input names the device itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    conv = convert_graph(small_resnet[1])
    x = _f32(2, 3, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv(input=x)
    got = conv(input=torch.from_numpy(x))["logits"]
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), conv.run({"input": x}, "cpu")["logits"].numpy())


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------

def test_hub_against_a_local_server(tmp_path, small_resnet):
    data = small_resnet[1]
    good = hashlib.sha256(data).hexdigest()
    manifest = [{"model": "resnet-small", "model_path": "vision/resnet-small.onnx",
                 "model_sha256": good, "opset_version": 17},
                {"model": "bad-model", "model_path": "vision/resnet-small.onnx",
                 "model_sha256": "0" * 64, "opset_version": 17},
                {"model": "evil", "model_path": "../evil.onnx", "model_sha256": good}]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = (json.dumps(manifest).encode() if self.path.endswith("manifest.json")
                    else data if self.path.endswith(".onnx") else None)
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        hub = ONNXHub(hub_dir=str(tmp_path / "cache"), base_url=url)
        assert hub.load("resnet-small") == data
        assert (tmp_path / "cache" / "vision" / "resnet-small.onnx").exists()
        assert ONNXHub(hub_dir=str(tmp_path / "cache")).load("resnet-small") == data
        with pytest.raises(ValueError, match="sha256 mismatch"):
            ONNXHub(hub_dir=str(tmp_path / "c2"), base_url=url).load("bad-model")
        with pytest.raises(ValueError, match="escapes|relative"):
            ONNXHub(hub_dir=str(tmp_path / "c3"), base_url=url).load("evil")
        (tmp_path / "cache" / "vision" / "resnet-small.onnx").write_bytes(b"truncated")
        assert hub.load("resnet-small") == data  # a corrupt cache entry heals
    finally:
        srv.shutdown()
    local = ONNXHub(hub_dir=str(tmp_path / "local"))
    local.save("tiny", data)
    assert local.load("tiny") == data
    with pytest.raises(FileNotFoundError, match="not cached"):
        local.load("resnet50")
    with open(local.model_path("tiny"), "ab") as f:
        f.write(b"corrupt")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        local.load("tiny")


def test_hub_reads_the_ports_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("SYNAPSEML_TORCH_HUB", str(tmp_path))
    monkeypatch.setenv("SYNAPSEML_TORCH_HUB_URL", "http://localhost:1/zoo/")
    hub = ONNXHub()
    assert hub.hub_dir == str(tmp_path) and hub.base_url == "http://localhost:1/zoo"


# ---------------------------------------------------------------------------
# ImageFeaturizer
# ---------------------------------------------------------------------------

def _featurizers(data, **kw):
    from synapseml_torch.onnx import ImageFeaturizer
    from synapseml_tpu.onnx import ImageFeaturizer as JImageFeaturizer

    kw = dict(input_col="image", output_col="features", image_height=32, image_width=32,
              mini_batch_size=4, **kw)
    return (ImageFeaturizer(device="cpu", **kw).set(model_payload=data),
            JImageFeaturizer(**kw).set(model_payload=data))


def _raw_images(seed=0):
    rs = _rng(seed)
    return [rs.integers(0, 256, size=(36 + 4 * i, 40 - 2 * i, 3)).astype(np.float32)
            for i in range(7)]


@pytest.mark.parametrize("head_less,center_crop", [(True, True), (True, False),
                                                   (False, True)])
def test_image_featurizer_matches_the_jax_stage(small_resnet, head_less, center_crop):
    """Ragged uint8-valued images through resize (and center crop),
    normalisation and the small ResNet cut at its Flatten output (or whole)
    in both packages: the same columns and shapes, features within 1e-5."""
    data = small_resnet[1]
    graph = P.parse_model(data).graph
    flat = next(n.output[0] for n in graph.node if n.op_type == "Flatten")
    kw = dict(head_less=head_less, center_crop=center_crop)
    if head_less:
        kw["feature_tensor_name"] = flat
    ours, theirs = _featurizers(data, **kw)
    imgs = _raw_images()
    parts = [{"image": _obj(imgs[:5]), "row": np.arange(5)},
             {"image": _obj(imgs[5:]), "row": np.arange(5, 7)}]
    got = ours.transform(pt.DataFrame([dict(p) for p in parts]))
    want = theirs.transform(JDataFrame([dict(p) for p in parts]))
    for p, q in zip(got.partitions, want.partitions):
        assert list(p) == list(q) == ["image", "row", "features"]
        assert all(np.array_equal(a, b) for a, b in zip(p["image"], q["image"]))
    _assert_same_frames(got.drop("image"), want.drop("image"))
    feats = np.concatenate([p["features"] for p in got.partitions])
    assert feats.shape == (7, 64 if head_less else 10) and feats.dtype == np.float32


def _obj(images):
    col = np.empty(len(images), dtype=object)
    col[:] = images
    return col


def test_image_featurizer_params_and_refusals(small_resnet):
    from synapseml_torch.onnx import ImageFeaturizer
    from synapseml_tpu.onnx import ImageFeaturizer as JImageFeaturizer

    ours = {k: v.default for k, v in ImageFeaturizer.params().items()}
    theirs = {k: v.default for k, v in JImageFeaturizer.params().items()}
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    df = pt.DataFrame.from_dict({"image": _obj(_raw_images()[:2])})
    with pytest.raises(ValueError, match="feature_tensor_name"):
        ImageFeaturizer(device="cpu").set(model_payload=small_resnet[1]).transform(df)
    with pytest.raises(ValueError, match="model_payload not set"):
        ImageFeaturizer(device="cpu").transform(df)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImageFeaturizer(head_less=False, image_height=32, image_width=32).set(
                model_payload=small_resnet[1]).transform(df)
