"""Test helper: small ONNX graphs written with the port's codec, run through
the port's converter on the CPU and through the JAX package's, on the same
numpy inputs (``tests/test_torch_onnx.py``'s pattern, shared by
``tests/test_torch_onnx_*.py``)."""

from __future__ import annotations

import numpy as np
import pytest

from synapseml_torch.onnx import convert_graph
from synapseml_torch.onnx import proto as P
from synapseml_tpu.onnx import convert_graph as jconvert_graph

I64 = np.int64


def f32(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def node(op, inputs, outputs, domain="", **attrs):
    return P.NodeProto(input=list(inputs), output=list(outputs), op_type=op, domain=domain,
                       attribute=[P.AttributeProto.make(k, v) for k, v in attrs.items()])


def vi(name, dtype=None, dims=()):
    return P.ValueInfoProto(name=name, elem_type=dtype or P.FLOAT, dims=list(dims))


def model_bytes(op, inputs, attrs=None, n_out=1, init=(), domain=""):
    """A one-node model: ``inputs[i]`` is an initializer when ``i`` is in
    ``init`` (the exporters' host constants), a graph input otherwise; None
    is an omitted input. Returns (bytes, feeds)."""
    names = [f"in{i}" if a is not None else "" for i, a in enumerate(inputs)]
    present = [(i, n, np.asarray(a)) for i, (n, a) in enumerate(zip(names, inputs))
               if a is not None]
    g = P.GraphProto(
        name=op, node=[node(op, names, [f"out{j}" for j in range(n_out)], domain,
                            **(attrs or {}))],
        initializer=[P.numpy_to_tensor(a, n) for i, n, a in present if i in init],
        input=[vi(n, P._NP_TO_DTYPE[a.dtype], a.shape) for i, n, a in present if i not in init],
        output=[P.ValueInfoProto(name=f"out{j}") for j in range(n_out)])
    return P.ModelProto(graph=g).encode(), {n: a for i, n, a in present if i not in init}


def graph_bytes(nodes, feeds: dict, inits: dict, outputs) -> bytes:
    g = P.GraphProto(name="g", node=list(nodes),
                     initializer=[P.numpy_to_tensor(np.asarray(v), k) for k, v in inits.items()],
                     input=[vi(k, P._NP_TO_DTYPE[np.asarray(v).dtype], np.shape(v))
                            for k, v in feeds.items()],
                     output=[P.ValueInfoProto(name=o) for o in outputs])
    return P.ModelProto(graph=g).encode()


def port(data, feeds) -> dict:
    return {k: v.numpy() for k, v in convert_graph(data).run(feeds, "cpu").items()}


def jax(data, feeds) -> dict:
    return {k: np.asarray(v) for k, v in jconvert_graph(data)(**feeds).items()}


def assert_same(ours: dict, theirs: dict, tol: float, what: str = "") -> None:
    """Same outputs, shapes and values: bitwise when ``tol`` is 0, else
    within ``tol`` (rtol and atol). Integer outputs are compared by value
    (the JAX package's are int32 where x64 is off, the port's int64 as
    ONNX says)."""
    assert ours.keys() == theirs.keys(), what
    for k in ours:
        a, b = ours[k], theirs[k]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if tol == 0 or a.dtype.kind in "biu":
            assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} <= {"i", "u"}, \
                (what, k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=tol,
                                       atol=tol, err_msg=f"{what} {k}")


def case(op, inputs, attrs=None, init=(), n_out=1, tol=1e-5, id=None):
    return pytest.param(op, inputs, attrs or {}, init, n_out, tol, id=id or op)


def run_case(op, inputs, attrs, init, n_out, tol):
    data, feeds = model_bytes(op, inputs, attrs, n_out, init)
    assert_same(port(data, feeds), jax(data, feeds), tol, op)
