"""synapseml_torch.scoring (``transform_source``) against synapseml_tpu.scoring.

The same seeded corpora go through both packages' scans. Host-side stages
give byte-identical sinks: part files, DONE markers and cursor records
equal the JAX package's. A bert-tiny ``DeepTextModel`` (weights bridged by
``convert_jax``, f32) and a small LightGBM classifier score within 1e-5
and 1e-4 of the JAX stages, id for id; the port's streamed LightGBM scores
equal its in-memory transform bitwise. Then the exactly-once contract of
``tests/test_scoring.py``: kill and resume at three cut points
byte-identical, two hosts (in turn and as two threads) equal one host, the
compile count bounded by the ladder, poisoned rows and an unreadable shard
quarantined (records equal to the JAX package's) or raised, a row-count
change refused, in-flight memory bounded, the ``synapseml_scoring_*``
series, and ``PipelineModel.transform_source``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")  # see ROADMAP.md section C: the onnx stand-in trap

from _torch_serving_stages import serving_pipelines  # noqa: E402
from synapseml_torch.core import batching as cb  # noqa: E402
from synapseml_torch.core import observability as obs  # noqa: E402
from synapseml_torch.core.dataframe import DataFrame  # noqa: E402
from synapseml_torch.core.faults import FaultSpec, inject_faults  # noqa: E402
from synapseml_torch.core.pipeline import Model, PipelineModel  # noqa: E402
from synapseml_torch.core.resilience import RetryPolicy  # noqa: E402
from synapseml_torch.data import ShardedSource  # noqa: E402
from synapseml_torch.data import MemorySource  # noqa: E402
from synapseml_torch.gbdt import LightGBMClassifier  # noqa: E402
from synapseml_torch.io import files as iofiles  # noqa: E402
from synapseml_torch.scoring import (JsonlSink, NpySink, ScoringContractError,  # noqa: E402
                                     assign_shards, iter_shard_batches, open_sink,
                                     plan_scan, transform_source)
from synapseml_tpu import scoring as jscoring  # noqa: E402
from synapseml_tpu.core import batching as jcb  # noqa: E402
from synapseml_tpu.core.dataframe import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.core.pipeline import Model as JModel  # noqa: E402
from synapseml_tpu.data import ShardedSource as JShardedSource  # noqa: E402
from synapseml_tpu.gbdt import LightGBMClassifier as JLightGBMClassifier  # noqa: E402
from synapseml_tpu.io import files as jiofiles  # noqa: E402

TOL_TEXT = 1e-5  # bert-tiny f32 scores, port against JAX
TOL_GBDT = 1e-4  # the forests' probabilities (tests/test_torch_gbdt.py)


# ---------------------------------------------------------------------------
# stages (each with its JAX twin) and corpora
# ---------------------------------------------------------------------------

def _numpy_score(df, dtype=np.float64):
    part = df.collect()
    x = np.asarray(np.stack(part["x"]), dtype)
    return df.with_column("score", x.sum(axis=-1))


class NumpyModel(Model):
    """Host scorer: score = sum(x) in float64."""

    def _transform(self, df):
        return _numpy_score(df)


class JNumpyModel(JModel):
    def _transform(self, df):
        return _numpy_score(df)


class SquareModel(Model):
    """A scorer through the port's CompiledCache: score = sum(x^2 + 1)."""

    fn_id = "torch_scoring_test_square"

    def _transform(self, df):
        x = torch.from_numpy(np.asarray(np.stack(df.collect()["x"]), np.float32))
        fn = cb.get_compiled_cache().get(self.fn_id, tuple(x.shape),
                                         lambda: (lambda a: (a * a + 1.0).sum(dim=-1)),
                                         instance=cb.instance_token(self))
        return df.with_column("score", fn(x))  # a tensor: the runner copies it to the host


class JSquareModel(JModel):
    def _transform(self, df):
        import jax

        x = np.asarray(np.stack(df.collect()["x"]), np.float32)
        fn = jcb.get_compiled_cache().get(
            "jax_scoring_test_square", x.shape,
            lambda: jax.jit(lambda a: (a * a + 1.0).sum(axis=-1)),
            instance=jcb.instance_token(self))
        return df.with_column("score", np.asarray(fn(x)))


def _poison_check(df):
    if np.any(np.asarray(df.collect()["flag"]) == 1):
        raise ValueError("poisoned row in batch")


class PoisonModel(NumpyModel):
    def _transform(self, df):
        _poison_check(df)
        return super()._transform(df)


class JPoisonModel(JNumpyModel):
    def _transform(self, df):
        _poison_check(df)
        return super()._transform(df)


class _Kill(BaseException):
    """An out-of-band kill: quarantine catches Exception, not this."""


class KillAfter(Model):
    def __init__(self, inner, after, **kw):
        super().__init__(**kw)
        self._inner, self._after, self._seen = inner, after, 0

    def _transform(self, df):
        if self._seen >= self._after:
            raise _Kill(f"killed after {self._seen} batches")
        self._seen += 1
        return self._inner._transform(df)


def _write_corpus(directory, sizes, n_features=4, flag_rows=(), seed=0):
    """One jsonl file a shard; rows carry a global id ``i``."""
    os.makedirs(directory, exist_ok=True)
    rs = np.random.default_rng(seed)
    i = 0
    for s, n in enumerate(sizes):
        with open(os.path.join(directory, f"in-{s:03d}.jsonl"), "w") as f:
            for _ in range(n):
                f.write(json.dumps({"x": [round(float(v), 5) for v in rs.normal(size=n_features)],
                                    "i": i, "flag": 1 if i in flag_rows else 0}) + "\n")
                i += 1
    return i


def _source(directory, retry_policy=None):
    return ShardedSource.jsonl(os.path.join(directory, "*.jsonl"), retry_policy=retry_policy)


def _jsource(directory, retry_policy=None):
    return JShardedSource.jsonl(os.path.join(directory, "*.jsonl"), retry_policy=retry_policy)


def _scan(stage, directory, sink, **kw):
    kw.setdefault("batch_rows", 8)
    return transform_source(stage, _source(directory), sink, host_index=kw.pop("host_index", 0),
                            host_count=kw.pop("host_count", 1), **kw)


def _jscan(stage, directory, sink, **kw):
    kw.setdefault("batch_rows", 8)
    return jscoring.transform_source(stage, _jsource(directory), sink,
                                     host_index=kw.pop("host_index", 0),
                                     host_count=kw.pop("host_count", 1), **kw)


def _part_bytes(sink):
    return b"".join(open(p, "rb").read() for p in sink.part_files())


def _ids(rows):
    return sorted(r["i"] for r in rows)


def _done_records(sink):
    return {i: {k: v for k, v in r.items()} for i, r in sink.completed().items()}


def _cursor(sink):
    return [{k: v for k, v in r.items() if k != "ts"} for r in sink.cursor_records()]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_host_stage_sink_is_byte_identical_to_jax(tmp_path):
    total = _write_corpus(tmp_path / "data", [37, 64, 5, 20])
    sink, jsink = JsonlSink(tmp_path / "port"), jscoring.JsonlSink(tmp_path / "jax")
    report = NumpyModel().transform_source(_source(tmp_path / "data"), sink, batch_rows=16,
                                           host_index=0, host_count=1)
    jreport = _jscan(JNumpyModel(), tmp_path / "data", jsink, batch_rows=16)
    assert report.complete and sink.is_complete() and report.rows_written == total
    for field in ("rows_written", "rows_padded", "batches", "shards_assigned", "shards_done",
                  "estimated_rows"):
        assert getattr(report, field) == getattr(jreport, field), field
    assert _part_bytes(sink) == _part_bytes(jsink) and _part_bytes(sink)
    assert _done_records(sink) == _done_records(jsink)
    assert _cursor(sink) == _cursor(jsink)
    assert open(tmp_path / "port" / "_SUCCESS").read() == open(tmp_path / "jax" / "_SUCCESS").read()


def test_compiled_stage_matches_jax_and_its_in_memory_transform(tmp_path):
    total = _write_corpus(tmp_path / "data", [37, 64, 5, 20])
    sink, jsink = JsonlSink(tmp_path / "port"), jscoring.JsonlSink(tmp_path / "jax")
    _scan(SquareModel(), tmp_path / "data", sink, batch_rows=16)
    _jscan(JSquareModel(), tmp_path / "data", jsink, batch_rows=16)
    rows, jrows = sink.collect_rows(), jsink.collect_rows()
    assert [r["i"] for r in rows] == [r["i"] for r in jrows] and _ids(rows) == list(range(total))
    np.testing.assert_allclose([r["score"] for r in rows], [r["score"] for r in jrows],
                               rtol=1e-6)
    src = _source(tmp_path / "data")
    eager = SquareModel().transform(DataFrame([src.read_shard(i)
                                               for i in range(src.num_shards)]))
    by_id = dict(zip(eager.collect_column("i").tolist(),
                     np.asarray(eager.collect_column("score")).tolist()))
    assert all(r["score"] == by_id[r["i"]] for r in rows)


@pytest.fixture(scope="module")
def text_models():
    jpipe, tpipe = serving_pipelines()
    return jpipe.get("stages")[1], tpipe.get("stages")[1]


def _write_texts(directory, sizes, seed=3):
    words = ("good great bad awful film plot acting score long short the a of and was is "
             "not very really quite").split()
    rs = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    i = 0
    for s, n in enumerate(sizes):
        with open(os.path.join(directory, f"in-{s:03d}.jsonl"), "w") as f:
            for _ in range(n):
                text = " ".join(rs.choice(words, size=int(rs.integers(1, 30))))
                f.write(json.dumps({"id": i, "text": text}) + "\n")
                i += 1
    return i


def test_deep_text_model_scan_matches_jax(tmp_path, text_models):
    jmodel, tmodel = text_models
    total = _write_texts(tmp_path / "data", [19, 40, 7])
    cols = ["id", "scores", "prediction"]
    sink, jsink = JsonlSink(tmp_path / "port", columns=cols), \
        jscoring.JsonlSink(tmp_path / "jax", columns=cols)
    report = _scan(tmodel, tmp_path / "data", sink, batch_rows=16)
    _jscan(jmodel, tmp_path / "data", jsink, batch_rows=16)
    rows, jrows = sink.collect_rows(), jsink.collect_rows()
    assert report.complete and [r["id"] for r in rows] == list(range(total))
    assert [r["id"] for r in rows] == [r["id"] for r in jrows]
    np.testing.assert_allclose([r["scores"] for r in rows], [r["scores"] for r in jrows],
                               atol=TOL_TEXT)
    assert [r["prediction"] for r in rows] == [r["prediction"] for r in jrows]
    assert _done_records(sink) == _done_records(jsink)


def _gbdt_data(n=400, f=6, seed=4):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3] > 0).astype(np.int64)
    return X, y


def test_lightgbm_scan_matches_jax_and_is_bitwise_its_in_memory_transform(tmp_path):
    X, y = _gbdt_data()
    kw = dict(num_iterations=8, learning_rate=0.3, num_leaves=7)
    data = {"features": X, "label": y}
    tmodel = LightGBMClassifier(device="cpu", **kw).fit(DataFrame.from_dict(data))
    jmodel = JLightGBMClassifier(**kw).fit(JDataFrame.from_dict(data))
    rs = np.random.default_rng(5)
    os.makedirs(tmp_path / "data")
    i = 0
    for s, n in enumerate((70, 33, 64)):
        with open(tmp_path / "data" / f"in-{s:03d}.jsonl", "w") as f:
            for row in rs.normal(size=(n, X.shape[1])):
                f.write(json.dumps({"features": [round(float(v), 5) for v in row], "id": i})
                        + "\n")
                i += 1
    cols = ["id", "prediction", "probability"]
    sink, jsink = JsonlSink(tmp_path / "port", columns=cols), \
        jscoring.JsonlSink(tmp_path / "jax", columns=cols)
    _scan(tmodel, tmp_path / "data", sink, batch_rows=32)
    _jscan(jmodel, tmp_path / "data", jsink, batch_rows=32)
    rows, jrows = sink.collect_rows(), jsink.collect_rows()
    assert [r["id"] for r in rows] == [r["id"] for r in jrows] == list(range(i))
    assert [r["prediction"] for r in rows] == [r["prediction"] for r in jrows]
    np.testing.assert_allclose([r["probability"] for r in rows],
                               [r["probability"] for r in jrows], atol=TOL_GBDT)
    src = _source(tmp_path / "data")
    eager = tmodel.transform(DataFrame([src.read_shard(j) for j in range(src.num_shards)]))
    want = dict(zip(eager.collect_column("id").tolist(),
                    np.stack(list(eager.collect_column("probability"))).tolist()))
    assert all(r["probability"] == want[r["id"]] for r in rows)  # bitwise


def test_npy_sink_parts_are_byte_identical_to_jax(tmp_path):
    total = _write_corpus(tmp_path / "data", [10, 22])
    sink = NpySink(tmp_path / "port", columns=["score", "i"])
    jsink = jscoring.NpySink(tmp_path / "jax", columns=["score", "i"])
    assert _scan(NumpyModel(), tmp_path / "data", sink).complete
    _jscan(JNumpyModel(), tmp_path / "data", jsink)
    assert sorted(sink.collect_column("i").tolist()) == list(range(total))
    assert sink.collect_column("score").dtype == np.float64
    assert sorted(sink.completed()[0]["files"]) == ["part-00000.i.npy", "part-00000.score.npy"]
    assert _part_bytes(sink) == _part_bytes(jsink)
    assert _done_records(sink) == _done_records(jsink)


def test_planner_matches_jax():
    for n_shards in (1, 5, 16, 17):
        for hosts in (1, 2, 3, 4, 16, 20):
            slices = [assign_shards(n_shards, h, hosts) for h in range(hosts)]
            assert slices == [jscoring.assign_shards(n_shards, h, hosts) for h in range(hosts)]
            flat = sorted(i for s in slices for i in s)
            assert flat == list(range(n_shards))
    with pytest.raises(ValueError):
        assign_shards(4, 2, 2)
    src = MemorySource({"x": np.zeros((100, 2))}, shard_rows=30)
    plan = plan_scan(src, batch_rows=64, host_index=0, host_count=1)
    assert plan.buckets == tuple(cb.default_bucketer().buckets_upto(64))
    from synapseml_tpu.data import MemorySource as JMemorySource

    jplan = jscoring.plan_scan(JMemorySource({"x": np.zeros((100, 2))}, shard_rows=30),
                               batch_rows=64, host_index=0, host_count=1)
    assert plan.buckets == jplan.buckets and plan.num_shards == jplan.num_shards


def test_tail_batches_pad_to_their_own_rung_as_jax():
    cols = {"x": np.arange(42, dtype=np.float32).reshape(21, 2), "i": np.arange(21),
            "url": np.asarray([f"u{i}" for i in range(21)], dtype=object)}
    got = list(iter_shard_batches(cols, batch_rows=16))
    want = list(jscoring.iter_shard_batches(cols, batch_rows=16))
    assert [(n, b, o) for _, n, b, o in got] == [(16, 16, 0), (5, 8, 16)]
    assert [(n, b, o) for _, n, b, o in got] == [(n, b, o) for _, n, b, o in want]
    for (batch, *_), (jbatch, *_) in zip(got, want):
        for k in cols:
            assert np.array_equal(batch[k], jbatch[k])
    assert np.array_equal(got[1][0]["x"][5], got[1][0]["x"][4])  # edge padding


# ---------------------------------------------------------------------------
# exactly once
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", [1, 4, 7])  # batches before the kill: early, mid, late
def test_kill_resume_is_byte_identical(tmp_path, cut):
    total = _write_corpus(tmp_path / "data", [30, 11, 42, 7, 25])
    clean = JsonlSink(tmp_path / "clean")
    _scan(SquareModel(), tmp_path / "data", clean, batch_rows=16)
    golden = _part_bytes(clean)
    jclean = jscoring.JsonlSink(tmp_path / "jclean")
    _jscan(JSquareModel(), tmp_path / "data", jclean, batch_rows=16)
    assert golden and [r["i"] for r in clean.collect_rows()] == \
        [r["i"] for r in jclean.collect_rows()]
    with pytest.raises(_Kill):
        _scan(KillAfter(SquareModel(), cut), tmp_path / "data", JsonlSink(tmp_path / "out"),
              batch_rows=16)
    sink = JsonlSink(tmp_path / "out")
    assert not sink.is_complete()
    report = _scan(SquareModel(), tmp_path / "data", sink, batch_rows=16)
    assert report.complete and report.shards_skipped + report.shards_done == 5
    assert _ids(sink.collect_rows()) == list(range(total))  # no duplicate, no gap
    assert _part_bytes(sink) == golden


def test_resume_is_a_noop_when_complete(tmp_path):
    _write_corpus(tmp_path / "data", [12, 12])
    sink = JsonlSink(tmp_path / "out")
    _scan(NumpyModel(), tmp_path / "data", sink)
    before = _part_bytes(sink)
    report = _scan(NumpyModel(), tmp_path / "data", sink)
    assert report.rows_written == 0 and report.shards_done == 0
    assert report.shards_skipped == 2 and report.complete
    assert _part_bytes(sink) == before


def test_two_hosts_equal_one_host_in_turn_and_as_threads(tmp_path):
    total = _write_corpus(tmp_path / "data", [9, 21, 14, 3, 30])
    one = JsonlSink(tmp_path / "one")
    _scan(NumpyModel(), tmp_path / "data", one)
    r0 = _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "two"), host_count=2)
    assert not r0.complete
    r1 = _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "two"), host_index=1,
               host_count=2)
    assert r1.complete and r0.shards_done + r1.shards_done == 5
    assert _part_bytes(JsonlSink(tmp_path / "two")) == _part_bytes(one)

    reports, errors = {}, []
    model = SquareModel()

    def host(idx):
        try:
            reports[idx] = _scan(model, tmp_path / "data", JsonlSink(tmp_path / "threads"),
                                 host_index=idx, host_count=2)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and reports[0].shards_done + reports[1].shards_done == 5
    assert JsonlSink(tmp_path / "threads").finalize(5)
    square = JsonlSink(tmp_path / "square")
    _scan(SquareModel(), tmp_path / "data", square)
    assert _part_bytes(JsonlSink(tmp_path / "threads")) == _part_bytes(square)
    assert _ids(square.collect_rows()) == list(range(total))


def test_corpus_scan_compile_count_bounded_by_ladder(tmp_path):
    _write_corpus(tmp_path / "data", [3, 17, 33, 64, 50, 7, 12, 31, 2, 29])
    model = SquareModel()
    model.fn_id = "torch_scoring_ladder_bound"
    cache = cb.get_compiled_cache()
    before = cache.miss_count(model.fn_id)
    plan = plan_scan(_source(tmp_path / "data"), batch_rows=32, host_index=0, host_count=1)
    _scan(model, tmp_path / "data", JsonlSink(tmp_path / "out"), batch_rows=32)
    misses = cache.miss_count(model.fn_id) - before
    assert 0 < misses <= len(plan.buckets), (misses, plan.buckets)


def test_padded_rows_counted_and_never_written(tmp_path):
    total = _write_corpus(tmp_path / "data", [13])
    sink = JsonlSink(tmp_path / "out")
    report = _scan(NumpyModel(), tmp_path / "data", sink)
    assert report.rows_written == total and report.rows_padded == 3
    assert len(sink.collect_rows()) == total


def test_row_count_changing_transform_is_a_contract_error(tmp_path):
    class Dropper(Model):
        def _transform(self, df):
            return df.filter(lambda p: np.asarray(p["i"]) % 2 == 0)

    _write_corpus(tmp_path / "data", [10])
    with pytest.raises(ScoringContractError, match="row-preserving"):
        _scan(Dropper(), tmp_path / "data", JsonlSink(tmp_path / "out"))


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

def test_poisoned_rows_quarantined_as_jax(tmp_path):
    total = _write_corpus(tmp_path / "data", [20, 20], flag_rows=(5, 27))
    sink, jsink = JsonlSink(tmp_path / "port"), jscoring.JsonlSink(tmp_path / "jax")
    report = _scan(PoisonModel(), tmp_path / "data", sink)
    _jscan(JPoisonModel(), tmp_path / "data", jsink)
    assert report.complete and report.rows_quarantined == 2
    assert report.rows_written == total - 2
    assert _ids(sink.collect_rows()) == [i for i in range(total) if i not in (5, 27)]
    errs = sink.error_records()
    assert len(errs) == 2 and {e["data"]["i"] for e in errs} == {5, 27}
    assert errs == jsink.error_records()
    assert _part_bytes(sink) == _part_bytes(jsink)


def test_poisoned_rows_raise_when_on_error_raise(tmp_path):
    _write_corpus(tmp_path / "data", [10], flag_rows=(3,))
    with pytest.raises(ValueError, match="poisoned"):
        _scan(PoisonModel(), tmp_path / "data", JsonlSink(tmp_path / "out"), on_error="raise")


def test_unreadable_shard_quarantined_after_retries(tmp_path):
    total = _write_corpus(tmp_path / "data", [11, 13, 9])
    src = _source(tmp_path / "data", RetryPolicy(backoffs_ms=(1,)))
    sink = JsonlSink(tmp_path / "out")
    with inject_faults([FaultSpec("connection_error", match=src.shards()[1].target,
                                  planes=("data",))]) as plan:
        report = transform_source(NumpyModel(), src, sink, batch_rows=8, host_index=0,
                                  host_count=1)
    assert plan.injected
    assert report.shards_quarantined == 1 and report.shards_done == 2 and report.complete
    assert report.rows_written == total - 13
    assert any(e["kind"] == "shard" for e in sink.error_records())
    done = sink.completed()
    assert done[1]["quarantined"] and done[1]["rows"] == 0
    os.unlink(sink.done_path(1))  # a deliberate re-score
    report2 = _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "out"))
    assert report2.shards_done == 1 and report2.rows_written == 13
    assert _ids(JsonlSink(tmp_path / "out").collect_rows()) == list(range(total))


def test_shard_level_failure_quarantines_not_kills(tmp_path, monkeypatch):
    import synapseml_torch.scoring.runner as runner_mod

    _write_corpus(tmp_path / "data", [9, 9])
    real_iter = runner_mod.iter_shard_batches

    def exploding_iter(cols, *a, **kw):
        if np.any(np.asarray(cols["i"]) == 12):
            raise RuntimeError("synthetic batch-formation failure")
        return real_iter(cols, *a, **kw)

    monkeypatch.setattr(runner_mod, "iter_shard_batches", exploding_iter)
    sink = JsonlSink(tmp_path / "out")
    report = _scan(NumpyModel(), tmp_path / "data", sink, batch_rows=16)
    assert report.complete and report.shards_done == 1 and report.shards_quarantined == 1
    assert report.rows_written == 9 and _ids(sink.collect_rows()) == list(range(9))
    assert any("batch-formation" in e.get("error", "") for e in sink.error_records())
    with pytest.raises(RuntimeError, match="batch-formation"):
        _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "raise"), batch_rows=16,
              on_error="raise")


def test_string_and_object_columns_ride_through(tmp_path):
    os.makedirs(tmp_path / "data")
    with open(tmp_path / "data" / "in-000.jsonl", "w") as f:
        for i in range(11):
            rec = {"x": [float(i), 1.0], "i": i, "url": f"https://r/{i}"}
            if i % 3 == 0:
                rec["extra"] = "only-sometimes"
            f.write(json.dumps(rec) + "\n")
    sink, jsink = JsonlSink(tmp_path / "port"), jscoring.JsonlSink(tmp_path / "jax")
    report = _scan(NumpyModel(), tmp_path / "data", sink)
    _jscan(JNumpyModel(), tmp_path / "data", jsink)
    assert report.complete and report.rows_written == 11
    assert [r["url"] for r in sorted(sink.collect_rows(), key=lambda r: r["i"])] == \
        [f"https://r/{i}" for i in range(11)]
    assert _part_bytes(sink) == _part_bytes(jsink)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_npy_sink_skips_zero_row_parts_and_matches_exact_names(tmp_path):
    p1 = iofiles.npy_writer(str(tmp_path / "part-00000.c.npy"))
    p1.append(np.ones((4, 3), np.float32))
    p1.commit()
    iofiles.npy_writer(str(tmp_path / "part-00001.c.npy")).commit()  # (0,) float64
    sink = NpySink(tmp_path, columns=["c"])
    for shard, name in ((0, "part-00000.c.npy"), (1, "part-00001.c.npy")):
        sink._mark_done({"shard": shard, "rows": 4 if shard == 0 else 0, "files": [name],
                         "host": 0, "quarantined": False})
    out = sink.collect_column("c")
    assert out.shape == (4, 3) and out.dtype == np.float32

    d = tmp_path / "names"
    sink = NpySink(d, columns=["a", "raw.a"])
    for name, fill in (("part-00000.a.npy", 1.0), ("part-00000.raw.a.npy", 2.0)):
        iofiles.write_npy(str(d / name), np.full((3,), fill, np.float32))
    sink._mark_done({"shard": 0, "rows": 3, "files": ["part-00000.a.npy",
                                                      "part-00000.raw.a.npy"],
                     "host": 0, "quarantined": False})
    assert np.array_equal(sink.collect_column("a"), np.full((3,), 1.0))
    assert np.array_equal(sink.collect_column("raw.a"), np.full((3,), 2.0))


def test_foreign_markers_and_torn_sidecar_lines_tolerated(tmp_path):
    _write_corpus(tmp_path / "data", [7, 7])
    _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "out"))
    for name, body in (("part-00090.DONE", "{}"), ("part-00091.DONE", "null"),
                       ("part-00092.DONE", '{"shard": "x", "files": []}')):
        (tmp_path / "out" / name).write_text(body)
    assert sorted(JsonlSink(tmp_path / "out").completed()) == [0, 1]
    r = _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "out"))
    assert r.complete and r.shards_skipped == 2
    with open(tmp_path / "out" / "cursor-00000.jsonl", "a") as f:
        f.write('{"shard": 9, "rows"')
    with open(tmp_path / "out" / "errors-00000.jsonl", "a") as f:
        f.write('{"kind": "row", "half')
    s2 = JsonlSink(tmp_path / "out")
    assert len(s2.cursor_records()) >= 2 and s2.error_records() == []


def test_sink_atomic_under_injected_write_fault(tmp_path, monkeypatch):
    total = _write_corpus(tmp_path / "data", [15, 15, 15])
    out = tmp_path / "out"
    real_commit = iofiles.StreamedJsonlWriter.commit
    state = {"fails": 1}

    def flaky_commit(self):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise OSError("injected write fault")
        return real_commit(self)

    monkeypatch.setattr(iofiles.StreamedJsonlWriter, "commit", flaky_commit)
    with pytest.raises(OSError, match="injected write fault"):
        _scan(NumpyModel(), tmp_path / "data", JsonlSink(out))
    sink = JsonlSink(out)
    listing = os.listdir(out)
    assert not [n for n in listing if ".tmp." in n], listing
    committed = {os.path.basename(p) for p in sink.part_files()}
    assert not [n for n in listing if n.startswith("part-") and not n.endswith(".DONE")
                and n not in committed]
    assert _scan(NumpyModel(), tmp_path / "data", JsonlSink(out)).complete
    assert _ids(JsonlSink(out).collect_rows()) == list(range(total))


def test_part_files_appear_atomically_with_done_after_payload(tmp_path, monkeypatch):
    _write_corpus(tmp_path / "data", [6])
    order = []
    real_replace = os.replace

    def spy_replace(a, b):
        order.append(os.path.basename(b))
        return real_replace(a, b)

    monkeypatch.setattr(os, "replace", spy_replace)
    _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "out"))
    assert order.index("part-00000.jsonl") < order.index("part-00000.DONE") \
        < order.index("_SUCCESS")


def test_scan_memory_bounded_by_queue_not_dataset(tmp_path):
    directory = tmp_path / "data"
    os.makedirs(directory)
    rs = np.random.default_rng(0)
    i = 0
    for s in range(24):
        with open(directory / f"in-{s:03d}.jsonl", "w") as f:
            for _ in range(256):
                f.write(json.dumps({"x": [round(float(v), 5) for v in rs.normal(size=16)],
                                    "i": i}) + "\n")
                i += 1
    dataset_bytes = sum(os.path.getsize(directory / n) for n in os.listdir(directory))
    report = _scan(NumpyModel(), directory, JsonlSink(tmp_path / "out"), batch_rows=64,
                   prefetch=2)
    assert report.rows_written == i
    assert report.peak_inflight_bytes < 8 * dataset_bytes / 24
    assert report.peak_inflight_bytes < dataset_bytes / 3


def test_sink_factory_projection_and_cursor(tmp_path):
    assert isinstance(open_sink(tmp_path / "a"), JsonlSink)
    assert isinstance(open_sink(tmp_path / "b", "npy", ["score"]), NpySink)
    with pytest.raises(ValueError, match="columns"):
        open_sink(tmp_path / "c", "npy")
    with pytest.raises(ValueError, match="unknown sink format"):
        open_sink(tmp_path / "d", "parquet")
    _write_corpus(tmp_path / "data", [5, 5, 5])
    sink = JsonlSink(tmp_path / "out", columns=["i", "score"])
    _scan(NumpyModel(), tmp_path / "data", sink)
    assert all(sorted(r) == ["i", "score"] for r in sink.collect_rows())
    recs = sink.cursor_records()
    assert [r["shard"] for r in recs] == [0, 1, 2]
    assert all(r["host"] == 0 and "ts" in r for r in recs)


def test_pipeline_model_rides_the_scoring_plane(tmp_path):
    total = _write_corpus(tmp_path / "data", [14])
    sink = JsonlSink(tmp_path / "out")
    report = PipelineModel(stages=[NumpyModel()]).transform_source(
        _source(tmp_path / "data"), sink, batch_rows=8, host_index=0, host_count=1)
    assert report.complete and report.rows_written == total
    assert "score" in sink.collect_rows()[0]


def test_scoring_metrics_series_emitted(tmp_path):
    _write_corpus(tmp_path / "data", [13])
    _scan(NumpyModel(), tmp_path / "data", JsonlSink(tmp_path / "out"))
    text = obs.get_registry().exposition()
    for series in ("synapseml_scoring_rows_total", "synapseml_scoring_padded_rows_total",
                   "synapseml_scoring_shards_total", "synapseml_scoring_batch_ms",
                   "synapseml_scoring_rows_per_sec", "synapseml_scoring_progress_pct",
                   "synapseml_scoring_eta_s"):
        assert series in text, series


# ---------------------------------------------------------------------------
# io.files writers
# ---------------------------------------------------------------------------

def test_streamed_writers_match_jax_bytes(tmp_path):
    p = str(tmp_path / "x.jsonl")
    w = iofiles.jsonl_writer(p)
    w.write_row({"a": 1, "v": np.float32(0.1), "t": torch.tensor([1.5, 2.0]),
                 "b": b"bytes", "n": np.arange(3)})
    assert not os.path.exists(p)
    w.commit()
    jw = jiofiles.jsonl_writer(str(tmp_path / "j.jsonl"))
    jw.write_row({"a": 1, "v": np.float32(0.1), "t": np.asarray([1.5, 2.0], np.float32),
                  "b": b"bytes", "n": np.arange(3)})
    jw.commit()
    assert open(p, "rb").read() == open(tmp_path / "j.jsonl", "rb").read()
    w2 = iofiles.jsonl_writer(p)
    w2.write_row({"a": 999})
    w2.abort()
    assert json.loads(open(p).read())["a"] == 1
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    with pytest.raises(TypeError, match="not JSON-serializable"):
        iofiles.json_default(object())

    for name, mod in (("x.npy", iofiles), ("j.npy", jiofiles)):
        with mod.npy_writer(str(tmp_path / name)) as nw:
            nw.append(np.arange(6, dtype=np.float32).reshape(3, 2))
            nw.append(np.full((4, 2), 7, np.float32))
        mod.write_npy(str(tmp_path / ("s" + name)), np.float64(3.5))
    assert open(tmp_path / "x.npy", "rb").read() == open(tmp_path / "j.npy", "rb").read()
    assert open(tmp_path / "sx.npy", "rb").read() == open(tmp_path / "sj.npy", "rb").read()
    arr = np.load(tmp_path / "x.npy")
    assert arr.shape == (7, 2) and arr.dtype == np.float32
    with pytest.raises(ValueError, match="does not match"):
        with iofiles.npy_writer(str(tmp_path / "y.npy")) as nw:
            nw.append(np.zeros((2, 2), np.float32))
            nw.append(np.zeros((2, 3), np.float32))
