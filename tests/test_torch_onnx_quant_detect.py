"""synapseml_torch's quantized, detection and data-dependent-shape ONNX ops
against the JAX package's converter, bitwise.

The integer products (``MatMulInteger``, ``QLinearMatMul``,
``QLinearConv``) are exact in both packages (int32 there, float64 sums
here), so every quantized output is compared bitwise, as are
``NonMaxSuppression`` (the reference's static, -1-padded layout),
``NonZero``, ``Compress`` and ``Unique``. A QDQ-quantized MLP runs end to
end through ``ONNXModel`` in both packages and against a numpy oracle.
The references are ``synapseml_tpu/onnx/convert.py`` :1180-1302,
:1359-1436 and :1999-2053.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import synapseml_torch as pt
from synapseml_torch.onnx import ONNXModel, convert_graph
from synapseml_torch.onnx import proto as P
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.onnx import ONNXModel as JONNXModel

sys.path.insert(0, str(Path(__file__).parent))
from _torch_onnx_graphs import (I64, assert_same, case, f32, graph_bytes, jax,  # noqa: E402
                                model_bytes, node, port, run_case, vi)

RS = np.random.default_rng(0)
XQ = f32(5, 7, seed=1, scale=4.0)
A8 = RS.integers(0, 255, (6, 9)).astype(np.uint8)
B8 = RS.integers(-128, 127, (9, 4)).astype(np.int8)
QA = RS.integers(0, 255, (5, 8)).astype(np.uint8)
QB = RS.integers(0, 255, (8, 6)).astype(np.uint8)

QUANT_CASES = [
    case("QuantizeLinear", [XQ, np.float32(0.05), np.uint8(128)], init=(1, 2), tol=0,
         id="quantize-uint8"),
    case("QuantizeLinear", [XQ, np.float32(0.05), np.int8(-3)], init=(1, 2), tol=0,
         id="quantize-int8-saturates"),
    case("QuantizeLinear", [XQ, np.float32(0.02)], init=(1,), tol=0, id="quantize-no-zero-point"),
    case("QuantizeLinear", [f32(3, 4, 5, seed=2), np.array([0.1, 0.02, 0.3, 0.5], np.float32),
                            np.array([0, 10, -5, 3], np.int8)], dict(axis=1), init=(1, 2),
         tol=0, id="quantize-per-axis"),
    case("DequantizeLinear", [A8, np.float32(0.05), np.uint8(128)], init=(1, 2), tol=0,
         id="dequantize"),
    case("DequantizeLinear", [RS.integers(-128, 127, (3, 4, 5)).astype(np.int8),
                              np.array([0.1, 0.02, 0.3, 0.5], np.float32),
                              np.array([0, 10, -5, 3], np.int8)], dict(axis=1), init=(1, 2),
         tol=0, id="dequantize-per-axis"),
    case("DynamicQuantizeLinear", [XQ], n_out=3, tol=0),
    case("DynamicQuantizeLinear", [np.zeros(3, np.float32)], n_out=3, tol=0,
         id="dynamic-quantize-all-zero"),
    case("MatMulInteger", [A8, B8, np.uint8(113), np.int8(-7)], tol=0),
    case("MatMulInteger", [A8, B8], tol=0, id="matmul-integer-no-zero-points"),
    case("MatMulInteger", [RS.integers(0, 255, (2, 3, 300)).astype(np.uint8),
                           RS.integers(0, 255, (300, 5)).astype(np.uint8),
                           RS.integers(0, 255, (3,)).astype(np.uint8), np.uint8(128)],
         tol=0, id="matmul-integer-batched-per-row-zero-point"),
    case("QLinearMatMul", [QA, np.float32(0.02), np.uint8(120), QB, np.float32(0.05),
                           np.uint8(131), np.float32(0.4), np.uint8(7)], init=(1, 2, 4, 5, 6, 7),
         tol=0),
    case("QLinearMatMul", [QA[:4, :7], RS.uniform(0.01, 0.05, 4).astype(np.float32),
                           RS.integers(100, 150, 4).astype(np.uint8), QB[:7, :5],
                           np.float32(0.05), np.uint8(131), np.float32(0.4), np.uint8(7)],
         tol=0, id="qlinear-matmul-per-row"),
    case("QLinearConv", [RS.integers(0, 255, (2, 3, 8, 8)).astype(np.uint8), np.float32(0.03),
                         np.uint8(110), RS.integers(-100, 100, (5, 3, 3, 3)).astype(np.int8),
                         RS.uniform(0.01, 0.05, 5).astype(np.float32), np.zeros(5, np.int8),
                         np.float32(0.1), np.uint8(128),
                         RS.integers(-1000, 1000, (5,)).astype(np.int32)],
         dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1]), init=(3, 4, 5, 8), tol=0,
         id="qlinear-conv-per-channel"),
    case("QLinearConv", [RS.integers(0, 255, (1, 4, 7, 7)).astype(np.uint8), np.float32(0.02),
                         np.uint8(100), RS.integers(0, 255, (4, 2, 3, 3)).astype(np.uint8),
                         np.float32(0.01), np.uint8(120), np.float32(0.3), np.int8(-5)],
         dict(strides=[2, 2], group=2), tol=0, id="qlinear-conv-groups-strided"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", QUANT_CASES)
def test_quantized_op_matches_jax_bitwise(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


def test_integer_products_are_exact_past_float32():
    """A K whose sums pass 2**24 (where an f32 accumulator rounds) is still
    exact: int64 numpy is the oracle."""
    a = np.full((2, 600), 255, np.uint8)
    b = np.full((600, 3), 127, np.int8)
    feeds = {"a": a, "b": b}
    data = graph_bytes([node("MatMulInteger", ["a", "b", "", "bz"], ["y"])], feeds,
                       {"bz": np.int8(-128)}, ["y"])
    want = a.astype(np.int64) @ (b.astype(np.int64) + 128)
    assert want.max() > 2 ** 24
    np.testing.assert_array_equal(port(data, feeds)["y"], want)


def _qmlp(rs):
    W = rs.integers(0, 255, (4, 3)).astype(np.uint8)
    inits = {"W": W, "xs": np.float32(0.02), "xz": np.uint8(128), "ws": np.float32(0.05),
             "wz": np.uint8(131), "ys": np.float32(0.3), "yz": np.uint8(100)}
    g = P.GraphProto(
        name="qmlp",
        node=[node("QuantizeLinear", ["x", "xs", "xz"], ["xq"]),
              node("QLinearMatMul", ["xq", "xs", "xz", "W", "ws", "wz", "ys", "yz"], ["yq"]),
              node("DequantizeLinear", ["yq", "ys", "yz"], ["yf"]),
              node("Relu", ["yf"], ["out"])],
        initializer=[P.numpy_to_tensor(np.asarray(v), k) for k, v in inits.items()],
        input=[vi("x", P.FLOAT, ["N", 4])], output=[vi("out", P.FLOAT, ["N", 3])])
    return P.ModelProto(graph=g).encode(), W


def test_qdq_model_end_to_end_through_the_stage():
    """Quantize -> QLinearMatMul -> Dequantize -> Relu through ONNXModel in
    both packages (partial rungs), bitwise, and against a numpy oracle."""
    rs = np.random.default_rng(5)
    data, W = _qmlp(rs)
    X = (rs.normal(size=(9, 4)) * 2).astype(np.float32)
    kw = dict(mini_batch_size=4, feed_dict={"x": "features"}, fetch_dict={"out": "out"})
    ours = ONNXModel(model_bytes=data, device="cpu", **kw).transform(
        pt.DataFrame.from_dict({"features": X}))
    theirs = JONNXModel(model_bytes=data, **kw).transform(JDataFrame.from_dict({"features": X}))
    got = np.stack(list(ours.collect_column("out")))
    np.testing.assert_array_equal(got, np.stack(list(theirs.collect_column("out"))))
    xq = np.clip(np.rint(X / np.float32(0.02)) + 128, 0, 255)
    acc = (xq - 128) @ (W.astype(np.float64) - 131)
    yq = np.clip(np.rint(acc * (0.02 * 0.05 / 0.3)) + 100, 0, 255)
    np.testing.assert_allclose(got, np.maximum((yq - 100) * 0.3, 0), atol=1e-6)


# ---------------------------------------------------------------------------
# detection and data-dependent shapes
# ---------------------------------------------------------------------------

def _boxes(seed, B=2, N=24):
    rs = np.random.default_rng(seed)
    centers, sizes = rs.uniform(0, 10, (B, N, 2)), rs.uniform(0.5, 3.0, (B, N, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=-1).astype(np.float32)


BOXES = _boxes(7)
SCORES = np.random.default_rng(8).uniform(0, 1, (2, 3, 24)).astype(np.float32)
CENTER_BOXES = np.array([[[5, 5, 2, 2], [5.1, 5, 2, 2], [20, 20, 2, 2]]], np.float32)

DETECT_CASES = [
    *(case("NonMaxSuppression", [BOXES, SCORES, np.array([5], I64), np.float32(i),
                                 np.float32(s)], init=(2,), tol=0, id=f"nms-iou{i}-score{s}")
      for i, s in ((0.5, 0.0), (0.3, 0.35))),
    case("NonMaxSuppression", [BOXES[:, :, [2, 3, 0, 1]], SCORES, np.array([30], I64),
                               np.float32(0.4)], init=(2, 3), tol=0,
         id="nms-flipped-corners-more-than-n"),
    case("NonMaxSuppression", [CENTER_BOXES, np.array([[[0.9, 0.8, 0.7]]], np.float32),
                               np.array([3], I64), np.float32(0.5)], dict(center_point_box=1),
         init=(2, 3), tol=0, id="nms-center-point"),
    case("NonMaxSuppression", [BOXES, SCORES, np.array([0], I64)], init=(2,), tol=0,
         id="nms-no-boxes"),
    case("NonZero", [np.array([[1, 0, 2], [0, 3, 0]], np.float32)], tol=0),
    case("NonZero", [f32(3, 4, 2) > 0.3], tol=0, id="nonzero-bool-3d"),
    case("Compress", [np.arange(12, dtype=np.float32).reshape(3, 4),
                      np.array([0, 1, 1, 0], bool)], dict(axis=1), tol=0),
    case("Compress", [np.arange(12, dtype=np.float32).reshape(3, 4),
                      np.array([1, 0, 1, 0, 1], bool)], tol=0, id="compress-flat-short"),
    *(case("Unique", [np.array([2, 1, 1, 3, 4, 3], I64)], dict(sorted=s), n_out=4, tol=0,
           id=f"unique-sorted{s}") for s in (1, 0)),
    case("Unique", [np.array([[1, 1], [2, 3], [1, 1]], np.float32)], dict(axis=0), n_out=4,
         tol=0, id="unique-axis"),
    case("Unique", [np.array([[3.0, 1.0], [2.0, 3.0]], np.float32)], dict(sorted=0), n_out=4,
         tol=0, id="unique-flat-first-occurrence"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", DETECT_CASES)
def test_detection_and_dynamic_op_matches_jax_bitwise(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


def test_detection_tail_through_converted_graph():
    """NMS -> Slice/Concat of the (batch, box) pairs -> GatherND of the
    selected boxes: device indices flowing between the new ops."""
    inits = {"mo": np.array([3], I64), "iou": np.float32(0.5), "s0": np.array([0], I64),
             "e1": np.array([1], I64), "s2": np.array([2], I64), "e3": np.array([3], I64),
             "ax1": np.array([1], I64)}
    data = graph_bytes(
        [node("NonMaxSuppression", ["boxes", "scores", "mo", "iou"], ["sel"]),
         node("Slice", ["sel", "s0", "e1", "ax1"], ["col_b"]),
         node("Slice", ["sel", "s2", "e3", "ax1"], ["col_i"]),
         node("Concat", ["col_b", "col_i"], ["idx"], axis=1),
         node("GatherND", ["boxes", "idx"], ["picked"])],
        {"boxes": np.zeros((1, 3, 4), np.float32), "scores": np.zeros((1, 1, 3), np.float32)},
        inits, ["picked"])
    boxes = np.array([[[0, 0, 1, 1], [3, 3, 4, 4], [8, 8, 9, 9]]], np.float32)
    feeds = {"boxes": boxes, "scores": np.array([[[0.7, 0.9, 0.8]]], np.float32)}
    ours = port(data, feeds)
    np.testing.assert_array_equal(ours["picked"], boxes[0][[1, 2, 0]])
    assert_same(ours, jax(data, feeds), 0)


def test_nms_oracle_greedy_numpy():
    """The padded layout against a greedy numpy NMS of every (batch, class)."""
    got = port(*_nms_bytes())["out0"]
    B, C, N = SCORES.shape[0], SCORES.shape[1], BOXES.shape[1]
    rows = []
    for b in range(B):
        lo, hi = np.minimum(BOXES[b, :, :2], BOXES[b, :, 2:]), np.maximum(BOXES[b, :, :2],
                                                                            BOXES[b, :, 2:])
        (y1, x1), (y2, x2) = lo.T, hi.T
        area = (y2 - y1) * (x2 - x1)
        for c in range(C):
            alive, picked = np.ones(N, bool), []
            while len(picked) < 5:
                masked = np.where(alive, SCORES[b, c], -np.inf)
                i = int(masked.argmax())
                if not masked[i] > 0.0:
                    break
                picked.append(i)
                inter = (np.maximum(np.minimum(y2, y2[i]) - np.maximum(y1, y1[i]), 0)
                         * np.maximum(np.minimum(x2, x2[i]) - np.maximum(x1, x1[i]), 0))
                alive &= inter / np.maximum(area + area[i] - inter, 1e-12) <= 0.5
                alive[i] = False
            rows += [[b, c, picked[k]] if k < len(picked) else [-1, -1, -1] for k in range(5)]
    np.testing.assert_array_equal(got, rows)
    assert got.dtype == np.int32


def _nms_bytes():
    return model_bytes("NonMaxSuppression", [BOXES, SCORES, np.array([5], I64),
                                             np.float32(0.5), np.float32(0.0)], init=(2,))


def test_dynamic_ops_follow_their_input():
    """A host input gives host outputs (shape math), a tensor input tensors
    on its device."""
    import torch

    from synapseml_torch.onnx.convert import OP_REGISTRY

    x = np.array([[0, 2], [3, 0]], np.int64)
    assert isinstance(OP_REGISTRY["NonZero"]([x], {}), np.ndarray)
    assert isinstance(OP_REGISTRY["NonZero"]([torch.from_numpy(x)], {}), torch.Tensor)
    outs = OP_REGISTRY["Unique"]([torch.from_numpy(x)], {})
    assert all(isinstance(o, torch.Tensor) for o in outs)
    assert convert_graph(_nms_bytes()[0]).run(_nms_bytes()[1], "cpu")["out0"].dtype == torch.int32
