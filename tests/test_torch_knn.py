"""synapseml_torch.nn (KNN, ConditionalKNN) against synapseml_tpu.nn.

The same seeded points through both packages' estimators: matches (value,
index, label) equal and distances within 1e-6, on random-normal points and
on integer-valued ones where ties at the k-th distance make the tie rule
decide (the port selects ``lax.top_k``'s lowest indices). Conditional KNN
applies the same ``INF`` bias mask. A saved model loads in the port with
the same answers, and the bucketed (padded) query path equals the unpadded
one (``tests/test_nn_recommendation.py:26-59``, ``tests/test_batching.py:495``).
"""

import contextlib

import numpy as np
import pytest
import torch

from synapseml_torch.core import DataFrame
from synapseml_torch.core import batching as cb
from synapseml_torch.nn import KNN, ConditionalKNN, ConditionalKNNModel, KNNModel
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.nn import KNN as JKNN
from synapseml_tpu.nn import ConditionalKNN as JConditionalKNN

TOL = 1e-6


def make_points(n=50, d=8, seed=0, integer=False):
    rs = np.random.default_rng(seed)
    if integer:
        return rs.integers(-2, 3, size=(n, d)).astype(np.float32)
    return rs.normal(size=(n, d)).astype(np.float32)


def _assert_same_matches(got, want, keys=("value", "index")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [[m[k] for k in keys] for m in g] == [[m[k] for k in keys] for m in w]
        np.testing.assert_allclose([m["distance"] for m in g], [m["distance"] for m in w],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("partitions", [1, 2])
def test_knn_matches_jax(integer, partitions):
    X = make_points(integer=integer)
    data = {"features": X, "values": np.arange(len(X))}
    model = KNN(k=4, device="cpu").fit(DataFrame.from_dict(data))
    jmodel = JKNN(k=4).fit(JDataFrame.from_dict(data))
    Q = make_points(7, seed=1, integer=integer)
    got = model.transform(DataFrame.from_dict({"features": Q}, num_partitions=partitions))
    want = jmodel.transform(JDataFrame.from_dict({"features": Q}, num_partitions=partitions))
    _assert_same_matches(got.collect_column("output"), want.collect_column("output"))
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    for i, row in enumerate(got.collect_column("output")):
        order = sorted(range(len(X)), key=lambda j: (d2[i, j], j))[:4]
        assert [m["value"] for m in row] == order
        dists = [m["distance"] for m in row]
        assert dists == sorted(dists)
    assert isinstance(model, KNNModel) and model.get("device") == "cpu"


def test_knn_ties_at_the_kth_distance_take_the_lowest_index():
    X = np.zeros((9, 4), np.float32)
    X[[2, 5, 7], 0] = 1.0  # three rows at the same distance from the query
    model = KNN(k=3, device="cpu").fit(DataFrame.from_dict(
        {"features": X, "values": np.arange(9)}))
    jmodel = JKNN(k=3).fit(JDataFrame.from_dict({"features": X, "values": np.arange(9)}))
    q = np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32)
    got = model.transform(DataFrame.from_dict({"features": q})).collect_column("output")
    want = jmodel.transform(JDataFrame.from_dict({"features": q})).collect_column("output")
    assert [m["index"] for m in got[0]] == [2, 5, 7]
    _assert_same_matches(got, want)


@pytest.mark.parametrize("integer", [False, True])
def test_conditional_knn_matches_jax(integer):
    X = make_points(40, integer=integer)
    labels = np.asarray(["a", "b", "c", "d"] * 10)
    data = {"features": X, "values": np.arange(40), "labels": labels}
    model = ConditionalKNN(k=5, device="cpu").fit(DataFrame.from_dict(data))
    jmodel = JConditionalKNN(k=5).fit(JDataFrame.from_dict(data))
    assert isinstance(model, ConditionalKNNModel)
    Q = make_points(6, seed=2, integer=integer)
    conds = np.empty(6, dtype=object)
    for i in range(6):
        conds[i] = ["a", "b"] if i % 2 == 0 else ("c" if i % 3 else ["z"])
    got = model.transform(DataFrame.from_dict({"features": Q, "conditioner": conds}))
    want = jmodel.transform(JDataFrame.from_dict({"features": Q, "conditioner": conds}))
    _assert_same_matches(got.collect_column("output"), want.collect_column("output"),
                         keys=("value", "index", "label"))
    for i, row in enumerate(got.collect_column("output")):
        allowed = {"a", "b"} if i % 2 == 0 else ({"c"} if i % 3 else set())
        assert {m["label"] for m in row} <= allowed and (bool(row) == bool(allowed))


def test_knn_model_save_load(tmp_path):
    X = make_points(20)
    model = KNN(k=3, device="cpu").fit(DataFrame.from_dict(
        {"features": X, "values": np.arange(20)}))
    q = DataFrame.from_dict({"features": X[:5]})
    before = [[m["value"] for m in r] for r in model.transform(q).collect_column("output")]
    model.save(str(tmp_path / "knn"))
    reloaded = KNNModel.load(str(tmp_path / "knn"))
    assert reloaded.get("device") == "cpu"
    after = [[m["value"] for m in r] for r in reloaded.transform(q).collect_column("output")]
    assert before == after and all(r[0] == i for i, r in enumerate(before))


@contextlib.contextmanager
def exact_bucketer(upto: int = 64):
    """A ladder with every rung: the unpadded execution."""
    prev = cb.set_default_bucketer(cb.ShapeBucketer(ladder=list(range(1, upto + 1))))
    try:
        yield
    finally:
        cb.set_default_bucketer(prev)


def test_knn_bucketed_matches_unpadded():
    rs = np.random.default_rng(5)
    X = rs.normal(size=(20, 4)).astype(np.float32)
    model = KNN(k=3, query_batch=8, device="cpu").fit(DataFrame.from_rows(
        [{"features": X[i], "values": f"v{i}"} for i in range(20)]))

    def transform(n):
        rq = np.random.default_rng(n)
        qdf = DataFrame.from_rows([{"features": rq.normal(size=4).astype(np.float32)}
                                   for _ in range(n)])
        return list(model.transform(qdf).collect_column("output"))

    for n in (1, 3, 9):
        padded = transform(n)
        with exact_bucketer():
            exact = transform(n)
        assert len(padded) == len(exact) == n
        _assert_same_matches(padded, exact)


def test_default_device_is_the_card():
    model = KNN(k=2).fit(DataFrame.from_dict({"features": make_points(5),
                                              "values": np.arange(5)}))
    assert model.get("device") == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.transform(DataFrame.from_dict({"features": make_points(2)}))
