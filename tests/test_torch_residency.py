"""synapseml_torch.fleet's multi-model residency against synapseml_tpu.fleet's.

The cases of ``tests/test_fleet.py:741-834`` run through each package over
the reference's MLP pipeline (``_aot_pipeline``; the port's twin over the
same ONNX bytes, ``_torch_worker_stages``) published to that package's
registry: four models on two ``serve_multi_model`` workers behind the
routing front under a byte budget that fits three (every reply within 1e-5
of the JAX package's and of its own model's in-process reply, the same
resident sets, evictions and misses); an artifact larger than the budget
and an unknown model refused; a failed load that never evicts its
neighbors. Past the reference: ``artifact_nbytes`` equals the JAX value on
one directory; ``/m/<model>`` groups get their own 404 or 500 and
``/admin/stats`` lists the resident set; an evicted resident's built module
is collected (a weakref dead after ``gc.collect()``, though the evicted
stage object is still held) and its ``CompiledCache`` entries are gone; and
``use_aot=True`` logs one ``aot_fallback`` line and warms up by JIT.
"""

import gc
import json
import logging
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from _aot_pipeline import build_pipeline, sample_rows
from _torch_worker_stages import Boom, mlp_pipeline
from synapseml_torch import fleet as tfleet
from synapseml_torch.core import batching as tcb
from synapseml_torch.core import observability as tobs
from synapseml_torch.core.pipeline import PipelineModel
from synapseml_torch.io import distributed_serving as tds
from synapseml_torch.registry import ModelRegistry
from synapseml_tpu import fleet as jfleet
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core.pipeline import PipelineModel as JPipelineModel
from synapseml_tpu.core.pipeline import Transformer as JTransformer
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.registry import ModelRegistry as JModelRegistry

PKGS = {"jax": dict(fleet=jfleet, ds=jds, obs=jobs),
        "torch": dict(fleet=tfleet, ds=tds, obs=tobs)}


class JBoom(JTransformer):
    """The JAX twin of ``_torch_worker_stages.Boom``: raises on every batch
    with rows."""

    def _transform(self, df):
        def per_part(p):
            if len(p["id"]):
                raise RuntimeError("this version fails every request")
            return p

        return df.map_partitions(per_part)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's registry with m0..m3 (seeds 10..13) and ``boom`` (the
    MLP followed by a stage that raises)."""
    base = tmp_path_factory.mktemp("residency_stores")
    jroot, root = str(base / "jax"), str(base / "torch")
    jreg, treg = JModelRegistry(jroot), ModelRegistry(root)
    for i in range(4):
        jpipe = build_pipeline(seed=10 + i)
        jreg.publish(f"m{i}", jpipe, version="v1")
        treg.publish(f"m{i}", mlp_pipeline(jpipe.get("stages")[1].get("model_payload")),
                     version="v1")
    jpipe = build_pipeline(seed=20)
    jreg.publish("boom", JPipelineModel(stages=jpipe.get("stages") + [JBoom()]), version="v1")
    tpipe = mlp_pipeline(jpipe.get("stages")[1].get("model_payload"))
    treg.publish("boom", PipelineModel(stages=tpipe.get("stages") + [Boom()]), version="v1")
    return {"jax": jroot, "torch": root}


def _store(pkg, stores):
    return stores["jax" if pkg["fleet"] is jfleet else "torch"]


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _expected_reply(seed, row):
    """The reference's ground truth: a locally built JAX pipeline through
    the serve loop's batch preparation."""
    from synapseml_tpu.core.dataframe import DataFrame
    from synapseml_tpu.io.serving import _prepare_batch

    batch = DataFrame([{
        "id": np.asarray(["x"], dtype=object), "method": np.asarray(["POST"], dtype=object),
        "path": np.asarray(["/"], dtype=object),
        "body": np.asarray([json.dumps(row).encode()], dtype=object)}])
    out = build_pipeline(seed=seed).transform(
        _prepare_batch(batch, parse_json=True, input_col="body"))
    return out.collect_column("reply")[0]


def _close(a, b):
    return a["pred"] == b["pred"] and np.allclose(a["probs"], b["probs"], atol=1e-5)


def test_residency_e2e_four_models_two_workers_budget_fits_three(stores):
    rows = {i: sample_rows(1, seed=100 + i)[0] for i in range(4)}
    expected = {i: _expected_reply(10 + i, rows[i]) for i in range(4)}
    assert len({json.dumps(e["probs"]) for e in expected.values()}) == 4

    def run(pkg):
        fleet, ds, obs = pkg["fleet"], pkg["ds"], pkg["obs"]
        store = _store(pkg, stores)
        probe = fleet.ResidencyManager(store, byte_budget=1 << 30)
        probe.acquire("m0")
        budget = int(probe.resident()["m0"]["nbytes"] * 3.5)
        probe.release_all()
        wreg = ds.WorkerRegistry()
        servers = []
        for pid in (1, 2):
            srv = fleet.serve_multi_model(fleet.ResidencyManager(store, byte_budget=budget),
                                          batch_interval_ms=2)
            servers.append(srv)
            urllib.request.urlopen(urllib.request.Request(
                wreg.address + "/register", data=json.dumps(
                    {"host": srv.host, "port": srv.port, "pid": -pid, "models": []}).encode(),
                method="POST"), timeout=10).read()
        front = ds.RoutingFront(registry=wreg)
        reg = obs.get_registry()
        evictions = reg.counter("synapseml_fleet_evictions_total", "residency LRU evictions",
                                ("model",))
        loads = reg.counter("synapseml_fleet_model_loads_total", "residency slot lookups",
                            ("model", "outcome"))

        def count(fam, **kw):
            return sum(fam.labels(model=f"m{i}", **kw).value for i in range(4))

        ev0, miss0 = count(evictions), count(loads, outcome="miss")
        try:
            replies, residents = [], []
            # an odd number of requests a round shifts the round-robin parity,
            # so both workers see all four models and their LRUs churn
            for round_i in range(8):
                for i in [0, 1, 2, 3, round_i % 4]:
                    status, reply = _post(front.address + fleet.model_path(f"m{i}"),
                                          json.dumps(rows[i]).encode())
                    assert status == 200 and _close(reply, expected[i]), (round_i, i, reply)
                    replies.append(reply["probs"])
                residents.append([sorted(s.residency.resident()) for s in servers])
            stats = []
            for srv in servers:
                with urllib.request.urlopen(srv.address + "/admin/stats", timeout=10) as r:
                    got = json.loads(r.read())
                assert set(got["resident"]) == set(srv.residency.resident())
                assert got["resident_bytes"] == srv.residency.resident_bytes() <= budget
                stats.append(sorted(got["resident"]))
            return {"replies": replies, "residents": residents, "stats": stats,
                    "evictions": count(evictions) - ev0,
                    "misses": count(loads, outcome="miss") - miss0}
        finally:
            front.close()
            wreg.close()
            for srv in servers:
                srv.residency.release_all()
                srv.stop()

    jrec, trec = run(PKGS["jax"]), run(PKGS["torch"])
    np.testing.assert_allclose(trec.pop("replies"), jrec.pop("replies"), atol=1e-5)
    assert trec == jrec
    assert trec["evictions"] > 0 and trec["misses"] >= trec["evictions"]
    assert all(len(r) <= 3 for step in trec["residents"] for r in step)


def test_residency_refuses_an_artifact_larger_than_the_budget(stores):
    def run(pkg):
        fleet = pkg["fleet"]
        out = []
        with pytest.raises(ValueError, match="exceeds the whole") as e:
            fleet.ResidencyManager(_store(pkg, stores), byte_budget=16).acquire("m0")
        out.append(str(e.value).split(" (")[0])
        with pytest.raises(KeyError, match="neither a version nor an alias") as e:
            fleet.ResidencyManager(_store(pkg, stores), byte_budget=1 << 30).acquire("ghost")
        out.append(type(e.value).__name__)
        return out

    assert run(PKGS["jax"]) == run(PKGS["torch"])


def test_residency_failed_load_never_evicts_healthy_neighbors(stores):
    def run(pkg):
        res = pkg["fleet"].ResidencyManager(_store(pkg, stores), byte_budget=1 << 30,
                                            refs={"m3": "ghost-ref"})
        for m in ("m0", "m1", "m2"):
            res.acquire(m)
        before = res.resident()
        for _ in range(3):  # every retry fails, the neighbors stay
            with pytest.raises(KeyError):
                res.acquire("m3")
        assert res.resident() == before
        res.release_all()
        return sorted(before), res.resident()

    assert run(PKGS["jax"]) == run(PKGS["torch"]) == (["m0", "m1", "m2"], {})


def test_artifact_nbytes_equals_the_jax_value(stores):
    import os

    res = tfleet.ResidencyManager(stores["torch"], byte_budget=1 << 30)
    res.acquire("m1")
    path = os.path.dirname(res._slots["m1"].path)
    assert tfleet.artifact_nbytes(path) == jfleet.artifact_nbytes(path) \
        == res.resident()["m1"]["nbytes"] > 0
    res.release_all()


def test_multi_model_groups_get_their_own_404_and_500(stores):
    rows = [sample_rows(1, seed=100 + i)[0] for i in range(3)]

    def run(pkg):
        fleet = pkg["fleet"]
        srv = fleet.serve_multi_model(fleet.ResidencyManager(_store(pkg, stores),
                                                             byte_budget=1 << 30),
                                      batch_interval_ms=2)
        try:
            out = [_post(srv.address + "/", b"{}"),
                   _post(srv.address + fleet.model_path("ghost"), b"{}")[0],
                   _post(srv.address + fleet.model_path("boom"),
                         json.dumps(rows[0]).encode()),
                   _post(srv.address + fleet.model_path("m2"), json.dumps(rows[1]).encode())]
            with urllib.request.urlopen(srv.address + "/admin/stats", timeout=10) as r:
                stats = json.loads(r.read())
            out.append((sorted(stats["resident"]), stats["resident_bytes"] > 0))
            return out
        finally:
            srv.residency.release_all()
            srv.stop()

    jrec, trec = run(PKGS["jax"]), run(PKGS["torch"])
    assert _close(trec[3][1], jrec[3][1])
    trec[3], jrec[3] = trec[3][0], jrec[3][0]
    assert trec == jrec
    assert trec[0][0] == 404 and "/m/<name>" in trec[0][1]["error"] and trec[1] == 404
    assert trec[2] == (500, {"error": "this version fails every request"})
    assert trec[3] == 200 and trec[4] == (["boom", "m2"], True)


def test_eviction_collects_the_module_and_its_compiled_cache_entries(tmp_path):
    from _torch_serving_stages import request_bodies, serving_pipelines

    root = str(tmp_path / "store")
    reg = ModelRegistry(root)
    rows = request_bodies(3, seed=2)
    for name, seed in (("a", 0), ("b", 1)):
        reg.publish(name, serving_pipelines(seed=seed)[1], version="v1",
                    aot={"rows": rows, "buckets": [8]})
    probe = tfleet.ResidencyManager(root, byte_budget=1 << 30)
    probe.acquire("a")
    budget = int(probe.resident()["a"]["nbytes"] * 1.5)
    probe.release_all()

    res = tfleet.ResidencyManager(root, byte_budget=budget)
    stage_a, _ = res.acquire("a")  # the warmup built the module and filled the cache
    model_a = stage_a.get("stages")[1]
    module_ref = weakref.ref(model_a._module)
    token = tcb.instance_token(model_a)
    cache = tcb.get_compiled_cache()
    assert [k for k in cache._entries if k[1] == token]
    res.acquire("b")  # evicts a; the caller still holds a's stage object
    gc.collect()
    assert module_ref() is None
    assert not [k for k in cache._entries if k[1] == token]
    assert model_a._module is None and list(res.resident()) == ["b"]
    # an evicted stage still runs (it rebuilds what it dropped)
    from synapseml_torch.core.dataframe import DataFrame

    out = stage_a.transform(DataFrame.from_rows([{"id": "x", "body": rows[0]}]))
    assert "scores" in out.collect_column("reply")[0]
    res.release_all()


def test_use_aot_logs_one_fallback_and_warms_up_by_jit(stores, tmp_path, caplog):
    root = str(tmp_path / "store")
    jpipe = build_pipeline(seed=3)
    ModelRegistry(root).publish("mlp", mlp_pipeline(jpipe.get("stages")[1]
                                                    .get("model_payload")),
                                version="v1", aot={"rows": sample_rows(), "buckets": [8]})
    key = 'synapseml_deploy_aot_fallbacks_total{reason="unsupported"}'
    before = tobs.get_registry().snapshot().get(key, 0)
    misses0 = tcb.get_compiled_cache().stats()["misses"]
    res = tfleet.ResidencyManager(root, byte_budget=1 << 30, use_aot=True, warmup_cap=8)
    with caplog.at_level(logging.WARNING, logger="synapseml_torch.registry.aot"):
        stage, version = res.acquire("mlp")
    warned = [json.loads(r.message) for r in caplog.records
              if r.name == "synapseml_torch.registry.aot"]
    assert [w["event"] for w in warned] == ["aot_fallback"] and version == "v1"
    assert warned[0]["action"] == "JIT warmup (swap proceeds)"
    assert tobs.get_registry().snapshot()[key] == before + 1
    assert tcb.get_compiled_cache().stats()["misses"] > misses0  # the JIT warmup ran
    res.acquire("mlp")  # a hit loads nothing and logs nothing
    assert len([r for r in caplog.records if r.name == "synapseml_torch.registry.aot"]) == 1
    res.release_all()
