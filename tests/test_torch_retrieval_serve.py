"""synapseml_torch.retrieval.serve against synapseml_tpu.retrieval's fan-out.

As ``tests/test_retrieval.py:507-631``: two ``retrieval_worker_main``
processes of the port, each advertising half the shard roster of an index
the port built and published (``device="cpu"``), are queried through the
routing front's fan-out. Hash-trick embeddings are integer-valued, so
distances are exact and ties at the k-th distance are real: the merged ids
and distances equal the JAX package's search over the JAX-built index of
the same corpus, ties included. Documents logged through the port's
``RequestLogger`` are ingested and republished; each worker's alias watch
re-registers and the fresh documents are found with full coverage. Then
one worker is SIGKILLed on a count of fan-out replies: the replies are
partial, name the victim's shards, and the survivor's shards stay exact
(the JAX search over those shards). Bad requests and an unknown index are
refused by each package's front alike, and the worker stage's body
contract gives each package the same replies. A worker whose index names
the card exits non-zero on this host and never registers.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import synapseml_torch
from synapseml_torch.core.dataframe import DataFrame
from synapseml_torch.data.source import ShardedSource
from synapseml_torch.io.distributed_serving import RoutingFront, WorkerRegistry
from synapseml_torch.registry import ModelRegistry
from synapseml_torch.retrieval import (HashEmbedder, VectorIndexModel, build_index,
                                       ingest_deltas, publish_index)
from synapseml_tpu import retrieval as J
from synapseml_tpu.core.dataframe import DataFrame as JDataFrame
from synapseml_tpu.data.source import ShardedSource as JShardedSource
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.registry import ModelRegistry as JModelRegistry

DIM = 16
N_DOCS = 96


def _texts(n, start=0):
    return [f"doc{start + i} alpha{i % 3} beta{i % 5} gamma{i % 7}" for i in range(n)]


def _write_corpus(directory, texts, files=4):
    os.makedirs(directory, exist_ok=True)
    per = (len(texts) + files - 1) // files
    for f_i in range(files):
        with open(os.path.join(directory, f"corpus-{f_i:03d}.jsonl"), "w") as f:
            for i in range(f_i * per, min((f_i + 1) * per, len(texts))):
                f.write(json.dumps({"id": i, "text": texts[i]}) + "\n")


def _post(url, data, timeout=30.0):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _spawn(store, index, reg_url, shards, log_path):
    code = ("import synapseml_torch.retrieval.serve as s\n"
            f"s.retrieval_worker_main({store!r}, {index!r}, {reg_url!r}, "
            f"shards={shards!r}, refresh_s=0.2)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(synapseml_torch.__file__))))
    with open(log_path, "wb") as logf:
        return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf,
                                stderr=subprocess.STDOUT)


def _pairs(matches):
    return [[(m["id"], m["distance"]) for m in row] for row in matches]


@pytest.mark.chaos(timeout_s=180)
def test_fanout_equals_jax_search_then_ingest_and_partial_degradation(tmp_path):
    from synapseml_torch.continual import RequestLogger

    texts = _texts(N_DOCS)
    _write_corpus(str(tmp_path / "corpus"), texts)
    pattern = str(tmp_path / "corpus" / "*.jsonl")
    kw = dict(payload_fn=lambda i: {"text": texts[i]}, k=10, batch_rows=32)
    store = str(tmp_path / "store")
    registry = ModelRegistry(store)
    build_index(registry, "docs", HashEmbedder(dim=DIM), ShardedSource.jsonl(pattern),
                str(tmp_path / "work"), device="cpu", **kw)
    jregistry = JModelRegistry(str(tmp_path / "jstore"))
    J.build_index(jregistry, "docs", J.HashEmbedder(dim=DIM), JShardedSource.jsonl(pattern),
                  str(tmp_path / "jwork"), **kw)
    # the same index for the card: its worker must refuse this host
    publish_index(registry, "docs_card", str(tmp_path / "work" / "index"), device="cuda")
    roster = registry.resolve("docs", "latest").stage.get("shard_names")
    assert len(roster) >= 2
    half = (len(roster) + 1) // 2
    subsets = [roster[:half], roster[half:]]

    wreg = WorkerRegistry()
    front = RoutingFront(registry=wreg)
    reg_url = wreg.address + "/register"
    card = _spawn(store, "docs_card", reg_url, None, str(tmp_path / "card.log"))
    procs = [_spawn(store, "docs", reg_url, sub, str(tmp_path / f"worker{i}.log"))
             for i, sub in enumerate(subsets)]
    try:
        wreg.wait_for(2, timeout_s=120)
        emb = HashEmbedder(dim=DIM)
        E = emb.embed(texts)
        Q = E[[3, 17, 29, 41, 53, 67, 80, 95]] + np.float32(1.0)  # ties at the k-th
        url = front.address + "/retrieval/docs"
        jstage = jregistry.resolve("docs", "latest").stage

        status, reply, hdrs = _post(url, json.dumps({"queries": Q.tolist(), "k": 10}).encode())
        assert status == 200 and not reply["missing"] and "X-Retrieval-Partial" not in hdrs
        assert sorted(reply["shards"]) == sorted(roster)
        want = _pairs(jstage.search(Q, k=10))
        assert _pairs(reply["matches"]) == want
        past = _pairs(jstage.search(Q, k=11))
        assert sum(row[9][1] == row[10][1] for row in past) > 0  # ties at the k-th

        # documents logged through the port's logger -> delta shards -> v2
        fresh = [f"e2edoc{i} omega{i} live ingest" for i in range(8)]
        log_dir = str(tmp_path / "logs")
        with RequestLogger(log_dir, shard_rows=4) as lg:
            for t in fresh:
                lg.log(method="POST", path="/ingest/docs", body=json.dumps({"doc": t}).encode(),
                       reply=b"ok", status=200, latency_ms=1.0)
            lg.flush()
        report = ingest_deltas(registry, "docs", log_dir, HashEmbedder(dim=DIM),
                               str(tmp_path / "ingest"))
        assert report["version"] == "v2"
        J.ingest_deltas(jregistry, "docs", log_dir, J.HashEmbedder(dim=DIM),
                        str(tmp_path / "jingest"))
        jstage = jregistry.resolve("docs", "latest").stage  # the JAX v2
        assert jstage.get("shard_names") == registry.resolve("docs").stage.get("shard_names")
        probe = emb.embed([fresh[2]])[0].tolist()
        deadline, found = time.monotonic() + 60, False
        while time.monotonic() < deadline and not found:
            status, reply, _ = _post(url, json.dumps({"query": probe, "k": 3}).encode())
            assert status == 200  # no downtime across the version change
            top = reply["matches"][0]
            found = (bool(top) and top[0]["id"] == N_DOCS + 2 and not reply["missing"]
                     and [w["version"] for w in wreg.workers()] == ["v2", "v2"])
            if not found:
                time.sleep(0.1)
        assert found, "the delta shards never became queryable on both workers"

        # SIGKILL one worker once it has answered 6 fan-out sub-queries
        victim = procs[0]
        before = {w["pid"]: w for w in wreg.workers()}
        victim_shards = set(before[victim.pid]["shards"])
        statuses, partials = [], []
        for i in range(20):
            status, reply, hdrs = _post(url, json.dumps({"queries": Q[:2].tolist(),
                                                         "k": 5}).encode())
            statuses.append(status)
            if i == 5:
                victim.kill()
                victim.wait(timeout=30)
            if "X-Retrieval-Partial" in hdrs:
                missing = set(hdrs["X-Retrieval-Partial"].split(","))
                partials.append(missing)
                assert set(reply["missing"]) == missing and reply["matches"][0]
                assert not set(reply["shards"]) & missing
                want = _pairs(jstage.search(Q[:2], k=5, shard_names=reply["shards"]))
                assert _pairs(reply["matches"]) == want  # the survivor's shards, exact
        assert set(statuses) == {200}
        assert partials and partials[-1] <= victim_shards
        assert card.wait(timeout=60) != 0
        assert card.pid not in {w["pid"] for w in wreg.workers()}
    finally:
        for p in procs + [card]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        front.close()
        wreg.close()


def test_fanout_rejects_bad_requests_and_an_unknown_index_as_jax():
    got = []
    for ds in (jds, None):
        wreg = (ds.WorkerRegistry if ds else WorkerRegistry)()
        front = (ds.RoutingFront if ds else RoutingFront)(registry=wreg)
        try:
            base = front.address + "/retrieval/docs"
            got.append([_post(base, b"not json")[:2],
                        _post(base, json.dumps({"k": 3}).encode())[:2],
                        _post(base, json.dumps({"query": [1.0, 2.0]}).encode())[:2],
                        _post(front.address + "/retrieval/", b"{}")[0]])
        finally:
            front.close()
            wreg.close()
    assert got[0] == got[1]
    assert [s for s, _ in got[1][:3]] == [400, 400, 503]


def test_serving_body_contract_on_the_worker_stage_as_jax():
    rs = np.random.default_rng(6)
    X = rs.integers(-3, 4, size=(20, DIM)).astype(np.float32)
    bodies = [{"query": X[4].tolist(), "k": 2},
              {"queries": [X[9].tolist(), X[9].tolist()], "k": 3, "shards": ["s0"]},
              {"nonsense": True}]
    out = []
    for model, frame in (
            (J.VectorIndexModel(shard_names=["s0"], dim=DIM, k=4,
                                inline_shards={"s0": {"vectors": X}}), JDataFrame),
            (VectorIndexModel(shard_names=["s0"], dim=DIM, k=4,
                              inline_shards={"s0": {"vectors": X}}, device="cpu"), DataFrame)):
        replies = model.transform(frame.from_dict({"body": np.asarray(bodies, dtype=object)}))
        out.append([{k: (_pairs(v) if k == "matches" else v) for k, v in r.items()
                     if k != "scoring_ms"} for r in replies.collect_column("reply")])
    assert out[0] == out[1]
    assert out[1][0]["matches"][0][0] == (4, 0.0) and len(out[1][0]["matches"][0]) == 2
    assert out[1][1]["shards"] == ["s0"] and "error" in out[1][2]
