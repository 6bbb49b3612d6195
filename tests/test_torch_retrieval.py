"""synapseml_torch.retrieval against synapseml_tpu.retrieval.

Hash-trick embeddings and integer-valued vectors, so that distances are
exact in float32 and ties at the k-th distance are real: the port's top-k
must select ``lax.top_k``'s ids (the lowest index among equal distances),
which ``torch.topk`` alone does not promise. The cases of
``tests/test_retrieval.py:120-441``: the shard format (bytes equal to the
JAX package's, torn and corrupt shards), ``score_batches`` ids and
distances equal to the JAX scorer's, the compile bound, KNN and the index
agreeing, search invariant to shard partitioning, cosine, build -> publish
-> resolve -> search, ``ingest_deltas`` and ``compact_index`` over a request
log written by the JAX package's ``continual.RequestLogger`` (shards and
answers equal to the JAX package's), and an ingest SIGKILLed at two cut
points resuming byte-identical. Registries live in tmp dirs; the port runs
with ``device="cpu"``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synapseml_torch
from synapseml_torch.core import batching as cb
from synapseml_torch.core.dataframe import DataFrame
from synapseml_torch.data.source import ShardedSource
from synapseml_torch.registry import ModelRegistry
from synapseml_torch.retrieval import (HashEmbedder, VectorIndexModel, build_index,
                                       compact_index, ingest_deltas, list_shards, open_shard,
                                       publish_index, score_batches, write_shard)
from synapseml_torch.retrieval.metrics import retrieval_metrics
from synapseml_torch.retrieval.scorer import FN_ID, topk_smallest
from synapseml_tpu import retrieval as J
from synapseml_tpu.data.source import ShardedSource as JShardedSource
from synapseml_tpu.registry import ModelRegistry as JModelRegistry

DIM = 16


@pytest.fixture()
def fresh_cache():
    cache = cb.reset_compiled_cache()
    yield cache
    cb.reset_compiled_cache()


def _texts(n, start=0):
    return [f"doc{start + i} alpha{i % 3} beta{i % 5} gamma{i % 7}" for i in range(n)]


def _write_corpus(directory, n_docs, files=4):
    os.makedirs(directory, exist_ok=True)
    texts = _texts(n_docs)
    per = (n_docs + files - 1) // files
    for f_i in range(files):
        with open(os.path.join(directory, f"corpus-{f_i:03d}.jsonl"), "w") as f:
            for i in range(f_i * per, min((f_i + 1) * per, n_docs)):
                f.write(json.dumps({"id": i, "text": texts[i]}) + "\n")
    return texts


def _build(tmp_path, tag, n_docs=96, files=4, jax=False):
    """Corpus -> embed -> multi-shard index -> published v1, by either
    package. Returns (registry, texts)."""
    root = tmp_path / tag
    texts = _write_corpus(str(root / "corpus"), n_docs, files)
    pattern = str(root / "corpus" / "*.jsonl")
    kw = dict(payload_fn=lambda i: {"text": texts[i]}, k=10, batch_rows=32)
    if jax:
        registry = JModelRegistry(str(root / "store"))
        published, report = J.build_index(registry, "docs", J.HashEmbedder(dim=DIM),
                                          JShardedSource.jsonl(pattern), str(root / "work"),
                                          **kw)
    else:
        registry = ModelRegistry(str(root / "store"))
        published, report = build_index(registry, "docs", HashEmbedder(dim=DIM),
                                        ShardedSource.jsonl(pattern), str(root / "work"),
                                        device="cpu", **kw)
    assert published.version == "v1" and report.rows_written == n_docs
    return registry, texts


def _brute_topk_ids(E, ids, Q, k):
    """Exact float64 brute force under the (distance, id) rule."""
    E, Q = E.astype(np.float64), Q.astype(np.float64)
    d = np.sum(Q * Q, 1, keepdims=True) - 2.0 * Q @ E.T + np.sum(E * E, 1)[None, :]
    return [[int(ids[j]) for j in sorted(range(len(ids)), key=lambda j: (row[j], ids[j]))[:k]]
            for row in d]


def _matches(result):
    return [[(m["id"], m["distance"], m["payload"], m["shard"]) for m in row] for row in result]


def _tree_bytes(directory):
    out = {}
    for base, _, files in os.walk(directory):
        for fn in files:
            p = os.path.join(base, fn)
            out[os.path.relpath(p, directory)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# shard format
# ---------------------------------------------------------------------------

def test_shard_round_trip_is_byte_identical_to_jax(tmp_path):
    rs = np.random.default_rng(0)
    vec = rs.normal(size=(7, 5)).astype(np.float32)
    ids = np.arange(100, 107, dtype=np.int64)
    payloads = [{"text": f"p{i}"} for i in range(7)]
    sh = write_shard(str(tmp_path / "port"), "base-00000", vec, ids=ids, payloads=payloads)
    J.write_shard(str(tmp_path / "jax"), "base-00000", vec, ids=ids, payloads=payloads)
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    got = open_shard(sh.path, verify=True)
    np.testing.assert_array_equal(got.vectors(), vec)
    np.testing.assert_array_equal(got.ids(), ids)
    assert got.payloads() == payloads and (got.rows, got.dim, got.kind) == (7, 5, "base")
    assert got.nbytes > 0
    assert write_shard(str(tmp_path / "port"), "base-00000",
                       np.zeros((3, 5), np.float32)).rows == 7  # committed: kept
    assert [s.name for s in list_shards(str(tmp_path / "port"))] == ["base-00000"]


def test_torn_shard_invisible_and_corruption_detected(tmp_path):
    write_shard(str(tmp_path), "base-00000", np.ones((4, 3), np.float32))
    os.makedirs(tmp_path / ".tmp-base-00001")
    (tmp_path / ".tmp-base-00001" / "vectors.npy").write_bytes(b"torn")
    assert [s.name for s in list_shards(str(tmp_path))] == ["base-00000"]
    sh = list_shards(str(tmp_path))[0]
    np.save(os.path.join(sh.path, "vectors.npy"), np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="sha mismatch"):
        open_shard(sh.path, verify=True)
    with pytest.raises(ValueError, match="kind"):
        write_shard(str(tmp_path), "x", np.ones((2, 2), np.float32), kind="weird")
    with pytest.raises(ValueError, match="N, D"):
        write_shard(str(tmp_path), "x", np.ones(4, np.float32))
    with pytest.raises(ValueError, match="ids"):
        write_shard(str(tmp_path), "x", np.ones((2, 2), np.float32), ids=np.arange(3))


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,k,lo,hi", [(1, 37, 5, -3, 4), (2, 300, 7, -1, 2),
                                            (3, 200, 10, 0, 2), (4, 64, 64, -2, 3)])
def test_score_batches_equals_the_jax_scorer_under_ties(fresh_cache, seed, n, k, lo, hi):
    rs = np.random.default_rng(seed)
    Q = rs.integers(lo, hi, size=(21, 8)).astype(np.float32)
    X = rs.integers(lo, hi, size=(n, 8)).astype(np.float32)
    dist, idx = score_batches(Q, X, k, query_batch=8, device="cpu")
    jdist, jidx = J.score_batches(Q, X, k, query_batch=8)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(idx, jidx)
    assert _brute_topk_ids(X, np.arange(n), Q, k) == idx.tolist()
    full = np.sort(np.sum((Q[:, None] - X[None]) ** 2, -1), axis=1)
    if k < n:  # ties at the k-th distance are present, so the tie rule decides
        assert np.any(full[:, k - 1] == full[:, k])


def test_topk_smallest_orders_by_value_then_column():
    d = torch.tensor([[3.0, -0.0, 1.0, 0.0, 1.0, -2.5, 1.0],
                      [float("inf"), 2.0, 2.0, 2.0, -1e-30, 5.0, 2.0]])
    vals, pos = topk_smallest(d, 5)
    assert pos.tolist() == [[5, 1, 3, 2, 4], [4, 1, 2, 3, 6]]
    assert torch.equal(vals, torch.gather(d, 1, pos))
    import jax

    neg, jpos = jax.lax.top_k(-d.numpy(), 5)
    assert np.asarray(jpos).tolist() == pos.tolist()
    np.testing.assert_array_equal(-np.asarray(neg), vals.numpy())


def test_compile_bound_shared_across_same_shape_shards(fresh_cache):
    rs = np.random.default_rng(2)
    shards = [rs.normal(size=(64, DIM)).astype(np.float32) for _ in range(6)]
    sizes = [3, 17, 9, 30, 1, 24]
    buckets = {b for n in sizes for _s, _e, b in cb.default_bucketer().slices(n, 32)}
    miss0 = fresh_cache.miss_count(FN_ID)
    for n in sizes:
        Q = rs.normal(size=(n, DIM)).astype(np.float32)
        for X in shards:
            score_batches(Q, X, 5, query_batch=32, device="cpu")
    misses = fresh_cache.miss_count(FN_ID) - miss0
    assert 0 < misses <= len(buckets)  # not len(buckets) * len(shards)
    score_batches(rs.normal(size=(9, DIM)).astype(np.float32),
                  rs.normal(size=(64, DIM)).astype(np.float32), 5, query_batch=32, device="cpu")
    assert fresh_cache.miss_count(FN_ID) - miss0 == misses


def test_knn_and_vector_index_agree_with_each_other_and_jax(fresh_cache):
    from synapseml_torch.nn import KNN

    rs = np.random.default_rng(3)
    X = rs.integers(-3, 4, size=(40, DIM)).astype(np.float32)
    Q = rs.integers(-3, 4, size=(11, DIM)).astype(np.float32)
    knn = KNN(k=7, device="cpu").fit(DataFrame.from_dict(
        {"features": list(X), "values": np.arange(40)}))
    knn_out = knn.transform(DataFrame.from_dict({"features": list(Q)})).collect_column("output")
    model = VectorIndexModel(shard_names=["s0"], dim=DIM, k=7, device="cpu",
                             inline_shards={"s0": {"vectors": X}})
    jmodel = J.VectorIndexModel(shard_names=["s0"], dim=DIM, k=7,
                                inline_shards={"s0": {"vectors": X}})
    got = model.search(Q)
    assert _matches(got) == _matches(jmodel.search(Q))
    for km, vm in zip(knn_out, got):
        assert [m["index"] for m in km] == [m["id"] for m in vm]
        # KNN takes the square root in float32, the index in float64 (as in JAX)
        np.testing.assert_allclose([m["distance"] for m in km], [m["distance"] for m in vm],
                                   atol=1e-5)


def test_search_invariant_to_shard_partitioning(fresh_cache):
    rs = np.random.default_rng(4)
    X = rs.integers(-4, 5, size=(60, DIM)).astype(np.float32)
    Q = rs.integers(-4, 5, size=(9, DIM)).astype(np.float32)
    one = VectorIndexModel(shard_names=["all"], dim=DIM, k=10, device="cpu",
                           inline_shards={"all": {"vectors": X, "ids": np.arange(60)}})
    cuts = [(0, 23), (23, 41), (41, 60)]
    inline = {f"p{i}": {"vectors": X[a:b], "ids": np.arange(a, b)}
              for i, (a, b) in enumerate(cuts)}
    many = VectorIndexModel(shard_names=list(inline), dim=DIM, k=10, device="cpu",
                            inline_shards=inline)
    jmany = J.VectorIndexModel(shard_names=list(inline), dim=DIM, k=10, inline_shards=inline)
    r1, r3 = one.search(Q), many.search(Q)
    assert _matches(r3) == _matches(jmany.search(Q))
    for a, b in zip(r1, r3):
        assert [(m["id"], m["distance"]) for m in a] == [(m["id"], m["distance"]) for m in b]
    assert [[m["id"] for m in row] for row in r1] == _brute_topk_ids(X, np.arange(60), Q, 10)


def test_cosine_metric_normalizes_queries(fresh_cache):
    rs = np.random.default_rng(5)
    X = rs.normal(size=(30, DIM)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    model = VectorIndexModel(shard_names=["s"], dim=DIM, k=3, metric="cosine", device="cpu",
                             inline_shards={"s": {"vectors": X}})
    jmodel = J.VectorIndexModel(shard_names=["s"], dim=DIM, k=3, metric="cosine",
                                inline_shards={"s": {"vectors": X}})
    q = X[7] * 250.0
    r_scaled, r_unit = model.search(q[None, :])[0], model.search(X[7][None, :])[0]
    assert [m["id"] for m in r_scaled] == [m["id"] for m in r_unit]
    assert r_scaled[0]["id"] == 7
    want = jmodel.search(q[None, :])[0]
    assert [m["id"] for m in r_scaled] == [m["id"] for m in want]
    np.testing.assert_allclose([m["distance"] for m in r_scaled],
                               [m["distance"] for m in want], atol=1e-3)


def test_resident_shards_and_the_serving_body_contract(fresh_cache):
    rs = np.random.default_rng(6)
    X = rs.integers(-3, 4, size=(20, DIM)).astype(np.float32)
    kw = dict(shard_names=["s0"], dim=DIM, k=4, index_name="body",
              inline_shards={"s0": {"vectors": X}})
    model, jmodel = VectorIndexModel(device="cpu", **kw), J.VectorIndexModel(**kw)
    bodies = np.asarray([{"query": X[4].tolist(), "k": 2},
                         json.dumps({"queries": [X[9].tolist()], "k": 1, "shards": ["s0"]}),
                         {"nonsense": True}], dtype=object)
    replies = model.transform(DataFrame.from_dict({"body": bodies})).collect_column("reply")
    from synapseml_tpu.core.dataframe import DataFrame as JDataFrame

    jreplies = jmodel.transform(JDataFrame.from_dict({"body": bodies})).collect_column("reply")
    for r, jr in zip(replies, jreplies):
        assert {k: v for k, v in r.items() if k != "scoring_ms"} == \
            {k: v for k, v in jr.items() if k != "scoring_ms"}
    assert replies[0]["matches"][0][0]["id"] == 4 and "error" in replies[2]
    X_dev = model._shard_data("s0")[0]
    assert X_dev.device.type == "cpu" and model._shard_data("s0")[0] is X_dev  # loaded once
    gauge = retrieval_metrics()["resident_bytes"].labels(index="body").value
    assert gauge == 20 * DIM * 4 + 20 * 4  # vectors and norms on the device
    model.set(device="cpu")
    assert model._shard_data("s0")[0] is not X_dev  # a device change reloads
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VectorIndexModel(**kw).search(X[:1])


# ---------------------------------------------------------------------------
# build, publish, ingest, compact
# ---------------------------------------------------------------------------

def test_build_publish_resolve_search_as_jax(tmp_path, fresh_cache):
    registry, texts = _build(tmp_path, "port")
    jregistry, _ = _build(tmp_path, "jax", jax=True)
    resolved, jresolved = registry.resolve("docs", "latest"), jregistry.resolve("docs", "latest")
    extra = resolved.manifest["extra"]["retrieval"]
    assert extra == jresolved.manifest["extra"]["retrieval"]
    assert extra["rows"] == len(texts) and extra["dim"] == DIM and len(extra["shards"]) > 1
    assert _tree_bytes(os.path.join(resolved.path, "shards")) == \
        _tree_bytes(os.path.join(jresolved.path, "shards"))
    stage = resolved.stage
    assert os.path.isdir(stage.shards_root()) and stage.get("device") == "cpu"
    E = HashEmbedder(dim=DIM).embed(texts)
    assert np.array_equal(E, J.HashEmbedder(dim=DIM).embed(texts))
    got = stage.search(E[[17, 3, 40]], k=5)
    assert _matches(got) == _matches(jresolved.stage.search(E[[17, 3, 40]], k=5))
    assert got[0][0]["id"] == 17 and got[0][0]["distance"] == 0.0
    assert got[0][0]["payload"] == {"text": texts[17]}
    with pytest.raises(FileExistsError):
        publish_index(registry, "docs", str(tmp_path / "port" / "work" / "index"),
                      version="v1", device="cpu")


def _log_docs(log_dir, texts):
    """Commit document traffic through the JAX package's RequestLogger."""
    from synapseml_tpu.continual import RequestLogger

    with RequestLogger(log_dir, shard_rows=8) as lg:
        for t in texts:
            lg.log(method="POST", path="/ingest/docs", body=json.dumps({"doc": t}).encode(),
                   reply=b"ok", status=200, latency_ms=1.0)
        lg.flush()


def _delta_shard_files(stage_dir):
    shards_dir = os.path.join(stage_dir, "shards")
    return {k: v for k, v in _tree_bytes(shards_dir).items() if k.startswith("delta-")}


def test_ingest_deltas_equals_jax(tmp_path, fresh_cache):
    registry, texts = _build(tmp_path, "port")
    jregistry, _ = _build(tmp_path, "jax", jax=True)
    fresh = [f"freshdoc{i} zeta{i} unique token stream" for i in range(10)]
    log_dir = str(tmp_path / "logs")
    _log_docs(log_dir, fresh)
    report = ingest_deltas(registry, "docs", log_dir, HashEmbedder(dim=DIM),
                           str(tmp_path / "ingest1"))
    jreport = J.ingest_deltas(jregistry, "docs", log_dir, J.HashEmbedder(dim=DIM),
                              str(tmp_path / "jingest1"))
    assert report["freshness_lag_s"] > 0
    for key in ("name", "base_version", "version", "docs", "delta_shards", "quarantined"):
        assert report[key] == jreport[key], key
    resolved, jresolved = registry.resolve("docs", "latest"), jregistry.resolve("docs", "latest")
    assert resolved.version == "v2" and resolved.stage.get("device") == "cpu"
    assert resolved.manifest["extra"] == jresolved.manifest["extra"]
    assert _delta_shard_files(resolved.path) == _delta_shard_files(jresolved.path)
    probe = HashEmbedder(dim=DIM).embed([fresh[3], texts[5]])
    got = resolved.stage.search(probe, k=3)
    assert _matches(got) == _matches(jresolved.stage.search(probe, k=3))
    assert got[0][0]["id"] == len(texts) + 3 and got[0][0]["distance"] == 0.0
    assert got[0][0]["shard"].startswith("delta-v1") and got[1][0]["id"] == 5
    assert ingest_deltas(registry, "docs", log_dir, HashEmbedder(dim=DIM),
                         str(tmp_path / "ingest2")) is None
    assert registry.resolve_ref("docs", "latest") == "v2"


def test_compaction_equals_jax_and_changes_no_answer(tmp_path, fresh_cache):
    regs = {"port": _build(tmp_path, "port", n_docs=40, files=2)[0],
            "jax": _build(tmp_path, "jax", n_docs=40, files=2, jax=True)[0]}
    log_dir = str(tmp_path / "logs")
    for round_i in range(2):
        _log_docs(log_dir, [f"round{round_i}doc{i} eta{i}" for i in range(6)])
        ingest_deltas(regs["port"], "docs", log_dir, HashEmbedder(dim=DIM),
                      str(tmp_path / f"ingest{round_i}"))
        J.ingest_deltas(regs["jax"], "docs", log_dir, J.HashEmbedder(dim=DIM),
                        str(tmp_path / f"jingest{round_i}"))
    pre = regs["port"].resolve("docs", "latest")
    deltas = [s for s in pre.manifest["extra"]["retrieval"]["shards"] if s["kind"] == "delta"]
    assert len(deltas) >= 2
    assert compact_index(regs["port"], "docs", str(tmp_path / "none"), threshold=10) is None
    report = compact_index(regs["port"], "docs", str(tmp_path / "compact"), threshold=2)
    jreport = J.compact_index(regs["jax"], "docs", str(tmp_path / "jcompact"), threshold=2)
    assert report == jreport and sorted(report["merged"]) == sorted(s["name"] for s in deltas)
    post, jpost = (regs[t].resolve("docs", "latest") for t in ("port", "jax"))
    assert post.version == report["version"]
    assert post.manifest["extra"] == jpost.manifest["extra"]
    assert all(s["kind"] == "base" for s in post.manifest["extra"]["retrieval"]["shards"])
    assert _tree_bytes(os.path.join(post.path, "shards")) == \
        _tree_bytes(os.path.join(jpost.path, "shards"))
    probe = HashEmbedder(dim=DIM).embed(["round1doc3 eta3", _texts(40)[11]])
    a, b = pre.stage.search(probe, k=5), post.stage.search(probe, k=5)
    assert [[m["id"] for m in r] for r in a] == [[m["id"] for m in r] for r in b]
    assert _matches(b) == _matches(jpost.stage.search(probe, k=5))


_INGEST_SCRIPT = """
import os, signal, sys
from synapseml_torch.registry import ModelRegistry
from synapseml_torch.retrieval import ingest as ingest_mod
from synapseml_torch.retrieval.build import HashEmbedder

root, log_dir, work_dir, cut = sys.argv[1:5]

class KillingEmbedder(HashEmbedder):
    def _transform(self, df):
        if cut == "embed":  # SIGKILL mid-embed: a torn sink part, no DONE
            os.kill(os.getpid(), signal.SIGKILL)
        return super()._transform(df)

if cut == "publish":
    def _boom(*a, **k):  # SIGKILL after the delta commit, before the publish
        os.kill(os.getpid(), signal.SIGKILL)
    ingest_mod._republish = _boom

ingest_mod.ingest_deltas(ModelRegistry(root), "docs", log_dir, KillingEmbedder(dim=16), work_dir)
"""


@pytest.mark.chaos(timeout_s=300)
def test_ingest_sigkill_resume_byte_identical(tmp_path):
    fresh = [f"killdoc{i} theta{i} resilient stream" for i in range(12)]
    log_dir = str(tmp_path / "logs")
    _log_docs(log_dir, fresh)
    gold_reg, _ = _build(tmp_path, "gold", n_docs=40, files=2)
    ingest_deltas(gold_reg, "docs", log_dir, HashEmbedder(dim=DIM), str(tmp_path / "gold_work"))
    golden = _delta_shard_files(gold_reg.resolve("docs", "latest").path)
    assert golden
    script = tmp_path / "run_ingest.py"
    script.write_text(_INGEST_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(synapseml_torch.__file__))), OMP_NUM_THREADS="1")
    for cut in ("embed", "publish"):
        reg, _ = _build(tmp_path, cut, n_docs=40, files=2)
        work = str(tmp_path / f"work_{cut}")
        proc = subprocess.run([sys.executable, str(script), str(tmp_path / cut / "store"),
                               log_dir, work, cut], env=env, timeout=240, capture_output=True)
        assert proc.returncode == -9, proc.stderr.decode()[-2000:]
        resolved = reg.resolve("docs", "latest")
        assert resolved.version == "v1"
        assert all(s["kind"] == "base" for s in resolved.manifest["extra"]["retrieval"]["shards"])
        if cut == "publish":
            assert any(s.kind == "delta" for s in list_shards(os.path.join(work, "index",
                                                                           "shards")))
        report = ingest_deltas(reg, "docs", log_dir, HashEmbedder(dim=DIM), work)
        assert report["version"] == "v2" and report["docs"] == len(fresh)
        assert _delta_shard_files(reg.resolve("docs", "latest").path) == golden
