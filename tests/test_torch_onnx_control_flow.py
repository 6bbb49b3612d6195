"""synapseml_torch's ONNX control flow (If, Loop, Scan) and random ops
against the JAX package.

The same graphs, written with the port's codec, run through the port on
the CPU and the JAX converter in its eager form, which is the port's only
form: outputs within 1e-6 (f32 sums in the same order), shapes equal,
including zero-trip loops and loops that exit early with scan outputs of
that many rows. The forms the JAX package refuses under ``jax.jit`` only
(If branches of different shapes, a data-dependent early exit with scan
outputs) run in the port as the JAX eager path runs them. Subgraphs read
the outer scope and bring their own initializers. The random ops cannot
draw ``jax.random``'s bits: they are held by distribution (4 sigma) and by
repeat (the same seed twice bitwise). The references are
``synapseml_tpu/onnx/convert.py`` :1916-1994 and :2084-2349.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.onnx import convert_graph
from synapseml_torch.onnx import proto as P
from synapseml_tpu.onnx import convert_graph as jconvert_graph

sys.path.insert(0, str(Path(__file__).parent))
from _torch_onnx_graphs import assert_same, f32, model_bytes, node, port, vi  # noqa: E402
from _torch_onnx_graphs import jax as jax_run  # noqa: E402

TOL = 1e-6


def _model(nodes, inputs, outputs, inits=()) -> bytes:
    g = P.GraphProto(name="g", node=nodes, input=inputs, output=[vi(o) for o in outputs],
                     initializer=[P.numpy_to_tensor(np.asarray(v), k) for k, v in inits])
    return P.ModelProto(graph=g).encode()


def _both(data, feeds, tol=TOL):
    ours = port(data, feeds)
    assert_same(ours, jax_run(data, feeds), tol)
    return ours


# ---------------------------------------------------------------------------
# Scan
# ---------------------------------------------------------------------------

def _scan_model(in_dirs=(0,), out_dirs=(0,), out_axes=(0,), two_inputs=False):
    """state s; per step s' = s + x_t (+ 2 * z_t), scan output s' * k with
    k a body initializer."""
    nodes = [node("Add", ["s_in", "x_t"], ["a"])]
    ins = [vi("s_in", dims=[2]), vi("x_t", dims=[2])]
    if two_inputs:
        nodes += [node("Mul", ["z_t", "two"], ["z2"]), node("Add", ["a", "z2"], ["s_out"])]
        ins.append(vi("z_t", dims=[2]))
    else:
        nodes.append(node("Identity", ["a"], ["s_out"]))
    nodes.append(node("Mul", ["s_out", "k"], ["y_t"]))
    body = P.GraphProto(name="body", node=nodes, input=ins, output=[vi("s_out"), vi("y_t")],
                        initializer=[P.numpy_to_tensor(np.float32(0.5), "k")])
    n_scan = 2 if two_inputs else 1
    attrs = dict(body=body, num_scan_inputs=n_scan, scan_input_directions=list(in_dirs),
                 scan_output_directions=list(out_dirs), scan_output_axes=list(out_axes))
    scan_ins = ["s0", "xs"] + (["zs"] if two_inputs else [])
    inputs = [vi("s0", dims=[2]), vi("xs", dims=[5, 2])] + ([vi("zs", dims=[2, 5])]
                                                           if two_inputs else [])
    if two_inputs:
        attrs["scan_input_axes"] = [0, 1]
    return _model([node("Scan", scan_ins, ["s_final", "ys"], **attrs)], inputs,
                  ["s_final", "ys"], inits=[("two", np.float32(2.0))])


XS = f32(5, 2, seed=1)


@pytest.mark.parametrize("in_dirs,out_dirs,out_axes", [((0,), (0,), (0,)), ((1,), (1,), (0,)),
                                                       ((1,), (0,), (1,)), ((0,), (1,), (1,))])
def test_scan_matches_jax(in_dirs, out_dirs, out_axes):
    data = _scan_model(in_dirs, out_dirs, out_axes)
    ours = _both(data, {"s0": np.zeros(2, np.float32), "xs": XS})
    seq = XS[::-1] if in_dirs[0] else XS
    ys = np.cumsum(seq, 0) * 0.5
    ys = ys[::-1] if out_dirs[0] else ys
    np.testing.assert_allclose(ours["ys"], ys.T if out_axes[0] else ys, rtol=1e-6)


def test_bidirectional_scan_matches_jax():
    """Two scan inputs, one read forward along axis 0, one backward along
    axis 1, with an outer-scope initializer in the body."""
    data = _scan_model(in_dirs=(0, 1), out_dirs=(1,), two_inputs=True)
    zs = f32(2, 5, seed=2)
    ours = _both(data, {"s0": np.ones(2, np.float32), "xs": XS, "zs": zs})
    want = 1 + np.cumsum(XS + 2 * zs.T[::-1], 0)
    np.testing.assert_allclose(ours["s_final"], want[-1], rtol=1e-6)


# ---------------------------------------------------------------------------
# Loop
# ---------------------------------------------------------------------------

def _loop_model(with_scan_output=True, early_exit_at=None):
    """Loop body: s' = s + (i+1)^2, scan output s'; cond_out = s' below
    the sum of the first ``early_exit_at`` squares (computed from the
    loop's data), else cond_in."""
    nodes = [node("Cast", ["i"], ["i_f"], to=P.FLOAT), node("Add", ["i_f", "one"], ["i1"]),
             node("Mul", ["i1", "i1"], ["sq"]), node("Add", ["s_in", "sq"], ["s_out"])]
    if early_exit_at is None:
        nodes.append(node("Identity", ["cond_in"], ["cond_out"]))
    else:  # the condition computed from a device value: read back each iteration
        nodes += [node("Less", ["s_out", "limit"], ["cond_out"])]
    outputs = [vi("cond_out"), vi("s_out")]
    if with_scan_output:
        nodes.append(node("Identity", ["s_out"], ["y_t"]))
        outputs.append(vi("y_t"))
    inits = [P.numpy_to_tensor(np.float32(1.0), "one")]
    if early_exit_at is not None:
        inits.append(P.numpy_to_tensor(np.float32(sum((k + 1) ** 2 for k in range(early_exit_at))
                                                  - 0.5), "limit"))
    body = P.GraphProto(name="body", node=nodes, input=[vi("i"), vi("cond_in"), vi("s_in")],
                        output=outputs, initializer=inits)
    outs = ["s_final"] + (["ys"] if with_scan_output else [])
    return _model([node("Loop", ["M", "cond0", "s0"], outs, body=body)],
                  [vi("M", P.INT64), vi("cond0", P.BOOL), vi("s0")], outs)


def _loop_feeds(M, cond0=True, s0=0.0):
    return {"M": np.int64(M), "cond0": np.array(cond0), "s0": np.float32(s0)}


@pytest.mark.parametrize("M,scan,exit_at,want_final,want_rows", [
    (4, True, None, 30.0, [1, 5, 14, 30]),                      # a for-loop
    (100, True, 3, 14.0, [1, 5, 14]),                           # early exit: 3 rows
    (np.iinfo(np.int64).max, False, 5, 55.0, None),             # torch's while-loop form
    (4, False, None, 30.0, None),
])
def test_loop_matches_jax(M, scan, exit_at, want_final, want_rows):
    ours = _both(_loop_model(scan, exit_at), _loop_feeds(M))
    assert float(ours["s_final"]) == want_final
    if want_rows is not None:
        np.testing.assert_array_equal(ours["ys"], want_rows)


def test_loop_zero_trips_keep_the_row_shape():
    body = P.GraphProto(name="body",
                        node=[node("Identity", ["cond_in"], ["cond_out"]),
                              node("Identity", ["s_in"], ["s_out"]),
                              node("Identity", ["s_in"], ["y_t"])],
                        input=[vi("i"), vi("cond_in"), vi("s_in", dims=[2])],
                        output=[vi("cond_out"), vi("s_out"), vi("y_t")])
    data = _model([node("Loop", ["M", "cond0", "s0"], ["s_final", "ys"], body=body)],
                  [vi("M", P.INT64), vi("cond0", P.BOOL), vi("s0", dims=[2])], ["s_final", "ys"])
    feeds = {"M": np.int64(5), "cond0": np.array(False), "s0": np.ones(2, np.float32)}
    ours = _both(data, feeds)
    assert ours["ys"].shape == (0, 2) and ours["ys"].dtype == np.float32
    ours = _both(_loop_model(), _loop_feeds(0, s0=7.0))
    assert float(ours["s_final"]) == 7.0 and ours["ys"].shape == (0,)


def test_loop_reads_the_outer_scope_through_a_nested_if():
    """A Loop whose body holds an If whose branches read an outer graph
    input (x) and a body value: the scope chain reaches both."""
    then_b = P.GraphProto(name="then", node=[node("Add", ["s_in", "x"], ["r"])],
                          output=[vi("r")])
    else_b = P.GraphProto(name="else", node=[node("Sub", ["s_in", "x"], ["r2"])],
                          output=[vi("r2")])
    body = P.GraphProto(
        name="body",
        node=[node("Cast", ["i"], ["i_f"], to=P.FLOAT),
              node("Less", ["i_f", "two"], ["small"]),
              node("If", ["small"], ["s_out"], then_branch=then_b, else_branch=else_b),
              node("Identity", ["cond_in"], ["cond_out"])],
        input=[vi("i"), vi("cond_in"), vi("s_in", dims=[3])],
        output=[vi("cond_out"), vi("s_out")],
        initializer=[P.numpy_to_tensor(np.float32(2.0), "two")])
    data = _model([node("Loop", ["M", "", "s0"], ["s_final"], body=body)],
                  [vi("M", P.INT64), vi("s0", dims=[3]), vi("x", dims=[3])], ["s_final"])
    x = f32(3, seed=3)
    ours = _both(data, {"M": np.int64(5), "s0": np.zeros(3, np.float32), "x": x})
    np.testing.assert_allclose(ours["s_final"], x + x - x - x - x, rtol=1e-6)


# ---------------------------------------------------------------------------
# If
# ---------------------------------------------------------------------------

def _if_model(divergent=False):
    """y = x * 2 if mean(x) > 0 else x - 1 (or, divergent, concat(x, x)):
    a condition computed from the data."""
    then_b = P.GraphProto(name="then", node=[node("Mul", ["x", "two"], ["y_then"])],
                          initializer=[P.numpy_to_tensor(np.float32(2.0), "two")],
                          output=[vi("y_then")])
    else_nodes = ([node("Concat", ["x", "x"], ["y_else"], axis=0)] if divergent
                  else [node("Sub", ["x", "one"], ["y_else"])])
    else_b = P.GraphProto(name="else", node=else_nodes,
                          initializer=[P.numpy_to_tensor(np.float32(1.0), "one")],
                          output=[vi("y_else")])
    return _model([node("ReduceMean", ["x"], ["m"], keepdims=0),
                   node("Greater", ["m", "zero"], ["cond"]),
                   node("If", ["cond"], ["y"], then_branch=then_b, else_branch=else_b)],
                  [vi("x", dims=[3])], ["y"], inits=[("zero", np.float32(0.0))])


POS, NEG = np.array([1.0, 2.0, 3.0], np.float32), np.array([-1.0, -2.0, -3.0], np.float32)


def test_if_takes_the_branch_its_data_names():
    data = _if_model()
    np.testing.assert_array_equal(_both(data, {"x": POS})["y"], POS * 2)
    np.testing.assert_array_equal(_both(data, {"x": NEG})["y"], NEG - 1)


def test_forms_refused_only_under_jit_run_as_the_jax_eager_path():
    """Shape-divergent If branches and a data-dependent early exit with a
    scan output: the JAX package refuses both under jax.jit, runs them
    eagerly; the port, eager only, runs them and agrees with that run."""
    data = _if_model(divergent=True)
    np.testing.assert_array_equal(_both(data, {"x": NEG})["y"], np.concatenate([NEG, NEG]))
    np.testing.assert_array_equal(_both(data, {"x": POS})["y"], POS * 2)
    conv = jconvert_graph(data)
    with pytest.raises(NotImplementedError, match="matching shapes"):
        jax.jit(lambda x: conv(x=x)["y"])(jnp.asarray(NEG))

    data = _loop_model(early_exit_at=3)
    np.testing.assert_array_equal(_both(data, _loop_feeds(100))["ys"], [1, 5, 14])
    conv = jconvert_graph(data)
    with pytest.raises(NotImplementedError, match="data-dependent"):
        jax.jit(lambda s0: conv(M=np.int64(100), cond0=np.array(True), s0=s0))(jnp.float32(0))


def test_control_flow_runs_on_the_calls_device_and_leaves_the_outer_scope():
    """Outputs come back as tensors on the call's device; a branch's values
    do not leak into the outer environment."""
    conv = convert_graph(_if_model())
    out = conv.run({"x": torch.from_numpy(POS)}, "cpu")["y"]
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    env = dict(conv.weights_on("cpu"))
    env["x"] = torch.from_numpy(POS)
    from synapseml_torch.onnx.convert import _exec_nodes

    _exec_nodes(conv._graph.nodes, env, torch.device("cpu"))
    assert "y_then" not in env and "two" not in env and "y" in env


# ---------------------------------------------------------------------------
# random ops
# ---------------------------------------------------------------------------

N_DRAWS = 20000


def _draw(op, inputs=(), **attrs):
    data, feeds = model_bytes(op, list(inputs), attrs)
    return port(data, feeds)["out0"]


def _within(mean, want, sigma, n, k=4.0):
    return abs(mean - want) <= k * sigma / np.sqrt(n)


def test_random_ops_by_distribution():
    a = _draw("RandomNormal", shape=[N_DRAWS], mean=3.0, scale=2.0, seed=1.0)
    assert a.dtype == np.float32 and a.shape == (N_DRAWS,)
    assert _within(a.mean(), 3.0, 2.0, N_DRAWS)
    assert _within(a.var(), 4.0, 4.0 * np.sqrt(2), N_DRAWS)
    u = _draw("RandomUniform", shape=[N_DRAWS], low=-1.0, high=5.0, seed=2.0)
    assert u.min() >= -1.0 and u.max() <= 5.0
    assert _within(u.mean(), 2.0, 6.0 / np.sqrt(12), N_DRAWS)
    like = _draw("RandomNormalLike", [np.zeros((3, 4), np.float64)], seed=3.0)
    assert like.shape == (3, 4) and like.dtype == np.float64
    ulike = _draw("RandomUniformLike", [np.zeros((200, 100), np.float32)], dtype=P.DOUBLE,
                  seed=3.0)
    assert ulike.dtype == np.float64 and _within(ulike.mean(), 0.5, 1 / np.sqrt(12), 20000)
    p = np.full((N_DRAWS,), 0.3, np.float32)
    bern = _draw("Bernoulli", [p], seed=4.0)
    assert set(np.unique(bern)) <= {0.0, 1.0} and bern.dtype == np.float32
    assert _within(bern.mean(), 0.3, np.sqrt(0.21), N_DRAWS)
    assert _draw("Bernoulli", [p], seed=4.0, dtype=P.BOOL).dtype == np.bool_
    probs = np.array([[0.2, 0.5, 0.3], [0.98, 0.01, 0.01]])
    m = _draw("Multinomial", [np.log(probs).astype(np.float32)], sample_size=5000, seed=5.0)
    assert m.shape == (2, 5000) and m.dtype == np.int32
    for row, pr in zip(m, probs):
        freq = np.bincount(row, minlength=3) / row.size
        assert all(_within(f, q, np.sqrt(q * (1 - q)), row.size) for f, q in zip(freq, pr))


def test_random_ops_repeat_by_seed_and_decorrelate_unseeded():
    data, _ = model_bytes("RandomNormal", [], dict(shape=[64], seed=7.0))
    conv = convert_graph(data)
    first = conv.run({}, "cpu")["out0"]
    assert torch.equal(first, conv.run({}, "cpu")["out0"])             # the same seed, bitwise
    other = port(*model_bytes("RandomNormal", [], dict(shape=[64], seed=8.0)))["out0"]
    assert not np.array_equal(first.numpy(), other)
    p = np.full(64, 0.5, np.float32)
    assert np.array_equal(_draw("Bernoulli", [p], seed=9.0), _draw("Bernoulli", [p], seed=9.0))
    # two unseeded nodes draw independently (ORT draws each node anew)
    two = _model([node("RandomNormalLike", ["x"], ["a"]), node("RandomNormalLike", ["x"], ["b"])],
                 [vi("x", dims=[64])], ["a", "b"])
    out = port(two, {"x": np.zeros(64, np.float32)})
    assert not np.array_equal(out["a"], out["b"])


def test_seed_is_the_float32_bits_as_the_reference_keys_it():
    """The seed attribute goes through float32 (the attribute's wire type):
    1.0 and 1.0 + 1e-9 are one seed, 1.0 and 1.5 two."""
    a = _draw("RandomUniform", shape=[16], seed=1.0)
    np.testing.assert_array_equal(a, _draw("RandomUniform", shape=[16], seed=1.0 + 1e-9))
    assert not np.array_equal(a, _draw("RandomUniform", shape=[16], seed=1.5))
