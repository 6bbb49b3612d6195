"""synapseml_torch's ONNX elementwise, reduction, layout and index ops
against the JAX package's converter.

Each case is a one-node model written with the port's codec; the same
numpy inputs from a seed go through both converters on the CPU. Floating
outputs agree within 1e-5 (rtol and atol, f32); integer, boolean, index
and bitwise outputs, and gathers and scatters of exact values, are
bitwise. The JAX package's references are ``synapseml_tpu/onnx/convert.py``
:938-1178 (the tail), :1437-1502 (trigonometric, Hardmax, LRN, Lp),
:1713-1732 (bitwise) and :749-766, :1303-1358 (index ops).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
from _torch_onnx_graphs import I64, case, f32, model_bytes, port, run_case  # noqa: E402

X = f32(3, 5, scale=3.0)
Y = f32(3, 5, seed=1, scale=3.0)
U = np.random.default_rng(2).uniform(-0.9, 0.9, size=(3, 5)).astype(np.float32)
HALVES = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -3.51], np.float32)
INTS = np.random.default_rng(3).integers(0, 255, (4, 5)).astype(np.int32)
INTS2 = np.random.default_rng(4).integers(0, 255, (4, 5)).astype(np.int32)
X4 = f32(2, 8, 3, 4, seed=5)
EXACT = np.random.default_rng(6).integers(-4, 5, (4, 5)).astype(np.float32)  # sums stay exact

TAIL_CASES = [
    *(case(o, [X]) for o in ("Floor", "Ceil", "Sign", "Softplus", "Softsign", "Mish", "Atan",
                             "Sinh", "Cosh", "Asinh", "Tan")),
    case("Round", [np.concatenate([HALVES, X.ravel()])], tol=0, id="round-half-to-even"),
    case("Reciprocal", [np.abs(X) + 0.5]),
    case("IsNaN", [np.where(X > 1, np.nan, X).astype(np.float32)], tol=0),
    *(case(o, [U]) for o in ("Asin", "Acos", "Atanh")),
    case("Acosh", [1.0 + np.abs(X)]),
    *(case(o, [X, Y, X], tol=0) for o in ("Min", "Max")),
    case("Sum", [X, Y, X]),
    case("Mean", [X, Y, X]),
    case("Sum", [X], id="sum-one-input"),
    case("Max", [X, np.float32(0.5)], init=(1,), tol=0, id="max-scalar-initializer"),
    *(case(o, [X > 0, Y > 0, X > 1], tol=0) for o in ("And", "Or", "Xor")),
    *(case(o, [X, Y], tol=0) for o in ("GreaterOrEqual", "LessOrEqual")),
    case("Mod", [np.array([-4, 7, 5, -9], I64), np.array([3, -3, 8, -4], I64)], tol=0,
         id="mod-int-sign-of-divisor"),
    case("Mod", [np.array([-4.3, 7.2, 5.5], np.float32), np.array([2.1, -3.3, 2.0], np.float32)],
         dict(fmod=1), id="mod-fmod"),
    case("PRelu", [X, np.float32(0.1)], init=(1,), id="prelu-scalar"),
    case("PRelu", [f32(2, 3, 4), f32(3, 1, seed=1)], init=(1,), id="prelu-channel"),
    case("Elu", [X], dict(alpha=0.5)),
    case("Selu", [X]),
    case("Celu", [X], dict(alpha=2.0)),
    case("ThresholdedRelu", [X], dict(alpha=1.0)),
    case("Shrink", [X], dict(lambd=0.5, bias=0.2)),
    *(case("IsInf", [np.array([np.inf, -np.inf, 1.0, np.nan], np.float32)], a, tol=0, id=i)
      for a, i in ((dict(), "isinf"), (dict(detect_negative=0), "isinf-positive"),
                   (dict(detect_positive=0), "isinf-negative"))),
    case("BitShift", [np.array([1, 2, 8, 255], np.uint8), np.uint8(2)], dict(direction="LEFT"),
         init=(1,), tol=0, id="bitshift-left"),
    case("BitShift", [np.array([1, 2, 8, 255], np.uint8), np.array([1, 0, 3, 4], np.uint8)],
         dict(direction="RIGHT"), tol=0, id="bitshift-right"),
    *(case("CumSum", [EXACT, np.array(1, I64)], dict(exclusive=e, reverse=r), init=(1,), tol=0,
           id=f"cumsum-exclusive{e}-reverse{r}") for e in (0, 1) for r in (0, 1)),
    case("CumSum", [np.arange(12, dtype=np.int32).reshape(3, 4), np.array(-2, I64)], init=(1,),
         tol=0, id="cumsum-int32-negative-axis"),
    case("OneHot", [np.array([0, 2, -1, 5], I64), np.array(4, I64),
                    np.array([2.0, 9.0], np.float32)], init=(1,), tol=0, id="onehot"),
    case("OneHot", [np.array([[0, 2], [-1, 1]], I64), np.array([3], I64),
                    np.array([0, 2 ** 24 + 1], I64)], dict(axis=0), init=(1,), tol=0,
         id="onehot-axis0-int64-values"),
    case("ArgMin", [X], dict(axis=1, keepdims=0), tol=0),
    case("ArgMin", [np.array([[1.0, 0.0, 0.0], [2.0, 2.0, 1.0]], np.float32)], tol=0,
         id="argmin-ties-first"),
    *(case(o, [X, np.array([1], I64)], init=(1,))
      for o in ("ReduceL1", "ReduceL2", "ReduceSumSquare", "ReduceLogSumExp")),
    case("ReduceLogSum", [np.abs(X) + 0.1, np.array([0, 1], I64)], dict(keepdims=0), init=(1,)),
    case("ReduceL2", [X, np.zeros(0, I64)], dict(noop_with_empty_axes=1), init=(1,), tol=0,
         id="reduce-l2-noop-empty-axes"),
    case("ReduceL1", [X4], dict(axes=[1, 3]), id="reduce-l1-axes-attribute"),
    *(case("DepthToSpace", [X4], dict(blocksize=2, mode=m), tol=0, id=f"depth-to-space-{m}")
      for m in ("DCR", "CRD")),
    case("SpaceToDepth", [f32(2, 3, 4, 6)], dict(blocksize=2), tol=0),
    case("ReverseSequence", [f32(4, 3, 2), np.array([4, 2, 1], I64)], init=(1,), tol=0),
    case("ReverseSequence", [f32(3, 5, 2), np.array([5, 0, 3], I64)],
         dict(batch_axis=0, time_axis=1), tol=0, id="reverse-sequence-batch-first"),
    case("EyeLike", [np.zeros((3, 5), np.float32)], dict(k=1), tol=0),
    case("EyeLike", [np.zeros((4, 3), np.float32)], dict(k=-1, dtype=7), tol=0,
         id="eyelike-int64"),
    case("Size", [X4], tol=0),
    case("Hardmax", [X], tol=0),
    case("Hardmax", [np.array([[1.0, 3.0], [3.0, 3.0]], np.float32)], dict(axis=0), tol=0,
         id="hardmax-axis0-ties"),
    case("LRN", [f32(2, 7, 3, 3)], dict(size=3, alpha=2e-4, beta=0.6, bias=1.5)),
    case("LRN", [f32(1, 5, 2, 2)], dict(size=4), id="lrn-even-size"),
    case("LpNormalization", [X], dict(axis=1, p=2), id="lp-2"),
    case("LpNormalization", [X], dict(axis=0, p=1), id="lp-1"),
    case("GlobalLpPool", [f32(2, 3, 4, 5)], dict(p=2)),
    case("GlobalLpPool", [f32(2, 3, 4)], dict(p=3), id="global-lp-pool-p3"),
    *(case(o, [INTS, INTS2], tol=0) for o in ("BitwiseAnd", "BitwiseOr", "BitwiseXor")),
    case("BitwiseNot", [INTS], tol=0),
    case("BitwiseNot", [INTS.astype(np.uint8)], tol=0, id="bitwise-not-uint8"),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", TAIL_CASES)
def test_tail_op_matches_jax(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


D3 = f32(2, 4, 5, seed=7)
IDX = np.random.default_rng(8)
INDEX_CASES = [
    case("Trilu", [f32(2, 4, 5)], tol=0, id="trilu-upper"),
    case("Trilu", [f32(4, 5), np.array(-1, I64)], dict(upper=0), init=(1,), tol=0,
         id="trilu-lower-k-1"),
    case("Trilu", [np.ones((5, 5), bool), np.array(1, I64)], init=(1,), tol=0,
         id="trilu-bool-k1"),
    case("GatherElements", [D3, IDX.integers(-4, 4, (2, 3, 5)).astype(I64)], dict(axis=1),
         tol=0, id="gather-elements-negative"),
    case("GatherElements", [D3, IDX.integers(0, 5, (2, 4, 2)).astype(I64)], dict(axis=-1),
         init=(1,), tol=0, id="gather-elements-initializer-indices"),
    case("GatherND", [D3, np.array([[0, 2], [1, -1]], I64)], tol=0),
    case("GatherND", [D3, np.array([[1], [3]], I64)], dict(batch_dims=1), tol=0,
         id="gather-nd-batch-dims"),
    case("GatherND", [D3, np.array([[[0, 1, 4]], [[1, 3, 0]]], I64)], tol=0,
         id="gather-nd-full-index"),
    case("ScatterElements", [D3, np.array([[[0, 2, 1, 3, -1]]] * 2, I64),
                             f32(2, 1, 5, seed=9)], dict(axis=1), tol=0,
         id="scatter-elements"),
    *(case("ScatterElements", [EXACT, np.array([[0, 1], [2, 0], [-1, 1], [3, 3]], I64),
                               np.full((4, 2), 2.0, np.float32)],
           dict(axis=0, reduction=r), tol=0, id=f"scatter-elements-{r}")
      for r in ("add", "mul", "min", "max")),
    case("ScatterND", [f32(4, 3), np.array([[1], [3]], I64), f32(2, 3, seed=1)], tol=0),
    *(case("ScatterND", [EXACT, np.array([[1, 2], [1, 2], [-1, 0]], I64),
                         np.array([3.0, -2.0, 4.0], np.float32)],
           dict(reduction=r), tol=0, id=f"scatter-nd-{r}")
      for r in ("add", "mul", "min", "max")),
]


@pytest.mark.parametrize("op,inputs,attrs,init,n_out,tol", INDEX_CASES)
def test_index_op_matches_jax(op, inputs, attrs, init, n_out, tol):
    run_case(op, inputs, attrs, init, n_out, tol)


def test_select_last_index_and_unknown_scatter_reduction_are_refused():
    for op in ("ArgMin", "ArgMax"):
        data, feeds = model_bytes(op, [X], dict(select_last_index=1))
        with pytest.raises(NotImplementedError, match="select_last_index"):
            port(data, feeds)
    data, feeds = model_bytes("ScatterElements", [X[0], np.array([0, 1], I64), X[0, :2]],
                              dict(reduction="bogus"))
    with pytest.raises(NotImplementedError, match="reduction"):
        port(data, feeds)


def test_one_hot_index_past_the_depth_is_an_off_row():
    data, feeds = model_bytes("OneHot", [np.array([1, 7], I64), np.array(3, I64),
                                         np.array([0.0, 1.0], np.float32)], init=(1,))
    np.testing.assert_array_equal(port(data, feeds)["out0"], [[0, 1, 0], [0, 0, 0]])


def test_shape_math_stays_on_the_host():
    """Min/Max/Sum and the comparisons over host int64 constants (the
    exporters' shape chains) stay numpy, as the stock binary ops do."""
    import torch

    from synapseml_torch.onnx.convert import OP_REGISTRY

    a, b = np.array([3, 9], I64), np.array([5, 2], I64)
    for op in ("Min", "Max", "Sum", "GreaterOrEqual", "BitwiseAnd"):
        out = OP_REGISTRY[op]([a, b], {})
        assert isinstance(out, np.ndarray), op
    assert isinstance(OP_REGISTRY["Size"]([torch.zeros(2, 3)], {}), np.ndarray)
