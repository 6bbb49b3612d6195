"""synapseml_torch.gbdt's out-of-core training against the JAX package.

``train_booster_from_source`` over the same jsonl and csv files as the
JAX ``train_booster_from_source``: split features equal, thresholds and
leaf values within 1e-5, and the streamed forest against the port's
in-memory fit on the same rows; the error cases and the empty byte-range
shards of ``tests/test_data.py:108,399,634-760``; injected read faults
retried during the passes.
"""

import json

import numpy as np
import pytest
import torch

from synapseml_torch.core import FaultSpec, inject_faults
from synapseml_torch.core.resilience import RetryPolicy, reset_resilience_measures, \
    resilience_measures
from synapseml_torch.data import ShardedSource
from synapseml_torch.gbdt import Booster, train_booster, train_booster_from_source
from synapseml_tpu.data import ShardedSource as JShardedSource
from synapseml_tpu.gbdt import train_booster_from_source as jtrain_from_source


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gbdt_dataset(d, n=2400, f=6, shards=4):  # tests/test_data.py:616-628
    rs = np.random.default_rng(1)
    X = rs.normal(size=(n, f)).astype(np.float32)
    w = rs.normal(size=f)
    y = (X @ w + 0.1 * rs.normal(size=n)).astype(np.float32)
    per = n // shards
    for i in range(shards):
        with open(d / f"g{i}.jsonl", "w") as fo:
            for j in range(i * per, (i + 1) * per):
                fo.write(json.dumps({"feat": X[j].tolist(), "label": float(y[j]),
                                     "cls": float(y[j] > 0),
                                     "k": float(np.digitize(y[j], [-1.0, 1.0]))}) + "\n")
    with open(d / "g.csv", "w") as fo:
        fo.write(",".join(f"f{k}" for k in range(f)) + ",label\n")
        for j in range(n):
            fo.write(",".join(repr(float(v)) for v in X[j]) + f",{float(y[j] > 0)!r}\n")
    return X, y


def _assert_same_forest(got: Booster, want):
    np.testing.assert_array_equal(got.feature, want.feature)
    np.testing.assert_allclose(got.threshold_value, want.threshold_value, rtol=1e-5)
    np.testing.assert_allclose(got.leaf_value, want.leaf_value, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.cover, want.cover)
    np.testing.assert_allclose(got.init_score, want.init_score, rtol=1e-6)
    assert got.max_depth == want.max_depth and got.params == want.params


@pytest.mark.parametrize("case", ["regression_jsonl", "binary_csv", "multiclass_jsonl"])
def test_streamed_forest_matches_jax(tmp_path, case):
    X, y = _gbdt_dataset(tmp_path)
    kw = dict(num_iterations=6, max_depth=4, chunk_rows=512)
    if case == "binary_csv":
        src = ShardedSource.csv(str(tmp_path / "g.csv"), shard_bytes=40_000)
        jsrc = JShardedSource.csv(str(tmp_path / "g.csv"), shard_bytes=40_000)
        kw.update(objective="binary", label_col="label",
                  feature_cols=[f"f{k}" for k in range(6)])
        assert src.num_shards >= 4
    else:
        src = ShardedSource.jsonl(str(tmp_path / "g*.jsonl"))
        jsrc = JShardedSource.jsonl(str(tmp_path / "g*.jsonl"))
        kw.update(objective="regression", label_col="label", feature_cols=["feat"])
        if case == "multiclass_jsonl":
            # a floor under the gain: splits of gain ~1e-6 are float noise,
            # and the two packages' summation orders break them apart
            kw.update(objective="multiclass", num_class=3, label_col="k", num_iterations=3,
                      min_gain_to_split=1e-3)
    got = train_booster_from_source(src, device="cpu", **kw)
    want = jtrain_from_source(jsrc, **kw)
    _assert_same_forest(got, want)
    np.testing.assert_allclose(got.raw_score(X, device="cpu"), want.raw_score(X),
                               rtol=1e-5, atol=1e-5)
    assert got.train_measures["iterations_count"] == kw["num_iterations"]


def test_streamed_gbdt_matches_in_memory_engine(tmp_path):  # tests/test_data.py:634
    X, y = _gbdt_dataset(tmp_path)
    src = ShardedSource.jsonl(str(tmp_path / "g*.jsonl"))
    streamed = train_booster_from_source(src, label_col="label", feature_cols=["feat"],
                                         objective="regression", num_iterations=15,
                                         max_depth=5, chunk_rows=512, device="cpu")
    in_mem = train_booster(X, y, objective="regression", num_iterations=15, max_depth=5,
                           device="cpu")
    mse_s = float(np.mean((streamed.predict(X, device="cpu") - y) ** 2))
    mse_m = float(np.mean((in_mem.predict(X, device="cpu") - y) ** 2))
    assert mse_s < 0.5 * float(np.var(y)), "streamed booster did not learn"
    assert mse_s < mse_m * 1.25, (mse_s, mse_m)
    np.testing.assert_array_equal(streamed.feature[0], in_mem.feature[0][:streamed.feature.shape[2]])


def test_streamed_binary_persistence_and_read_faults(tmp_path):
    X, y = _gbdt_dataset(tmp_path)
    reset_resilience_measures("data")
    src = ShardedSource.jsonl(str(tmp_path / "g*.jsonl"),
                              retry_policy=RetryPolicy(backoffs_ms=(1, 1, 1), jitter=False))
    with inject_faults([FaultSpec("connection_error", times=3, planes=("data",))]) as plan:
        b = train_booster_from_source(src, label_col="cls", feature_cols=["feat"],
                                      objective="binary", num_iterations=15, max_depth=5,
                                      chunk_rows=512, device="cpu")
    assert len(plan.injected) == 3
    assert resilience_measures("data").to_dict()["retry_count"] == 3
    assert float(np.mean((b.predict(X, device="cpu") > 0.5) == (y > 0))) > 0.85
    b.save(str(tmp_path / "model"))
    b2 = Booster.load(str(tmp_path / "model"), device="cpu")
    np.testing.assert_array_equal(b2.predict(X[:64]), b.predict(X[:64], device="cpu"))


def test_streamed_gbdt_skips_empty_byte_range_shards(tmp_path):  # tests/test_data.py:671
    rs = np.random.default_rng(0)
    with open(tmp_path / "g.jsonl", "w") as f:
        for i in range(120):
            x = rs.normal(size=4)
            row = {"feat": [round(float(v), 6) for v in x], "label": float(x.sum())}
            if i % 40 == 0:  # a long line spanning several byte ranges
                row["pad"] = "z" * 2000
            f.write(json.dumps(row) + "\n")
    kw = dict(label_col="label", feature_cols=["feat"], objective="regression",
              num_iterations=5, max_depth=4, chunk_rows=64)
    src = ShardedSource.jsonl(str(tmp_path / "g.jsonl"), shard_bytes=512)
    assert any(not cols for _, cols in src.iter_shards())  # empties exist
    b = train_booster_from_source(src, device="cpu", **kw)
    assert b.num_iterations == 5
    want = jtrain_from_source(JShardedSource.jsonl(str(tmp_path / "g.jsonl"), shard_bytes=512),
                              **kw)
    _assert_same_forest(b, want)


def test_streamed_errors_match_jax(tmp_path):
    with open(tmp_path / "g.jsonl", "w") as f:  # no 'label' column
        for i in range(20):
            f.write(json.dumps({"feat": [float(i)], "y": float(i)}) + "\n")
    with pytest.raises(ValueError, match="label_col"):
        train_booster_from_source(ShardedSource.jsonl(str(tmp_path / "g.jsonl")),
                                  num_iterations=2, device="cpu")
    with pytest.raises(ValueError, match="lambdarank"):
        train_booster_from_source(ShardedSource.jsonl(str(tmp_path / "g.jsonl")),
                                  objective="lambdarank", device="cpu")
    d = tmp_path / "drift"
    d.mkdir()
    with open(d / "a.jsonl", "w") as f:
        for i in range(30):
            f.write(json.dumps({"f0": float(i), "label": float(i)}) + "\n")
    with open(d / "b.jsonl", "w") as f:
        for i in range(30):
            f.write(json.dumps({"f0": float(i), "f1": 1.0, "label": float(i)}) + "\n")
    with pytest.raises(ValueError, match="feature_cols"):
        train_booster_from_source(ShardedSource.jsonl(str(d / "*.jsonl")), label_col="label",
                                  num_iterations=2, device="cpu")
    with pytest.raises(ValueError, match="missing feature column"):
        train_booster_from_source(ShardedSource.jsonl(str(d / "*.jsonl")), label_col="label",
                                  feature_cols=["f1"], num_iterations=2, device="cpu")


def test_streamed_gbdt_derives_depth_from_num_leaves(tmp_path):  # tests/test_data.py:732
    X, y = _gbdt_dataset(tmp_path)
    src = ShardedSource.jsonl(str(tmp_path / "g*.jsonl"))
    b = train_booster_from_source(src, label_col="label", feature_cols=["feat"],
                                  num_iterations=2, max_depth=-1, num_leaves=15,
                                  device="cpu")
    assert b.max_depth == 5 and b.feature.shape[2] == 63
