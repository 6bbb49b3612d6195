"""synapseml_torch's model registry against the JAX package's.

The store: the same tree ingests to the same blobs and ``files`` list, one
store directory is read and verified by both packages (the same signing
key, canonical JSON and layout), corruption and tampering raise
``IntegrityError``, GC prunes the same orphans. The registry: publish,
versions, aliases, pin and resolve, manifests with the JAX manifest's keys
that the JAX registry reads back. The deploy plane's warmup-only AOT
contract: a publish records no executables, a load by registry warms up by
JIT with its body's rows and pins the autotuned backend, and a manifest
that carries the JAX package's ``aot.entries`` falls back to that warmup
with one structured warning. ``apply_autotune`` pins what the JAX one pins;
on the card the search never pins the plain attention and raises a failing
kernel.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_serving_stages import request, request_bodies, serving_pipelines
from synapseml_torch.core import DataFrame
from synapseml_torch.core import observability as tobs
from synapseml_torch.io.serving import serve_pipeline
from synapseml_torch.registry import aot as taot
from synapseml_torch.registry import autotune as ttune
from synapseml_torch.registry import registry as treg
from synapseml_torch.registry import store as tstore
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.registry import aot as jaot
from synapseml_tpu.registry import autotune as jtune
from synapseml_tpu.registry import registry as jreg
from synapseml_tpu.registry import store as jstore


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipelines():
    return serving_pipelines()


def _tree(root):
    os.makedirs(os.path.join(root, "sub"))
    for rel, data in (("a.bin", b"\x00" * 1000), ("sub/b.json", b'{"k": 1}'),
                      ("sub/c.txt", b"same"), ("d.txt", b"same")):
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)
    return root


def test_store_matches_jax_and_shares_one_directory(tmp_path):
    src = _tree(str(tmp_path / "src"))
    root = str(tmp_path / "store")
    ts, js = tstore.ArtifactStore(root), jstore.ArtifactStore(root)
    files = ts.ingest_tree(src)
    assert files == js.ingest_tree(src) and len(os.listdir(os.path.join(root, "blobs"))) == 3
    assert tstore.sha256_file(os.path.join(src, "a.bin")) == \
        jstore.sha256_file(os.path.join(src, "a.bin"))
    obj = {"b": [1, 2.5, None], "a": {"z": "x", "y": (1, 2)}}
    assert tstore._canonical_json(obj) == jstore._canonical_json(obj)
    # one store, both packages: a manifest either signs, the other verifies
    ts.write_manifest("m", "v1", {"name": "m", "version": "v1", "files": files})
    js.write_manifest("m", "v2", {"name": "m", "version": "v2", "files": files})
    assert ts.read_manifest("m", "v2") == js.read_manifest("m", "v2")
    assert js.read_manifest("m", "v1") == ts.read_manifest("m", "v1")
    assert ts.list_versions("m") == js.list_versions("m") == ["v1", "v2"]
    ts.write_alias("m", "prod", "v1")
    assert js.list_aliases("m") == ts.list_aliases("m") == {"prod": "v1"}
    ts.materialize_tree(files, str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out" / "sub")) == ["b.json", "c.txt"]
    # tampering and corruption
    path = ts.manifest_path("m", "v1")
    with open(path) as f:
        man = json.load(f)
    man["files"] = []
    with open(path, "w") as f:
        json.dump(man, f)
    for store in (ts, js):
        with pytest.raises((tstore.IntegrityError, jstore.IntegrityError), match="signature"):
            store.read_manifest("m", "v1")
    digest = files[0]["sha256"]
    with open(ts.blob_path(digest), "ab") as f:
        f.write(b"!")
    with pytest.raises(tstore.IntegrityError, match="corrupt"):
        ts.get_blob(digest)
    with pytest.raises(tstore.IntegrityError, match="sha256 mismatch"):
        with open(os.path.join(src, "d.txt"), "rb") as f:
            tstore.write_stream_verified(f, str(tmp_path / "x.txt"), "0" * 64)
    assert not os.path.exists(tmp_path / "x.txt")
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    for bad in ("../x", ".hidden", "a/b", ""):
        with pytest.raises(ValueError, match="unsafe"):
            ts.manifest_path(bad, "v1")
    # GC: an orphan pruned by both (dry run first), referenced blobs kept
    orphan = ts.put_blob_bytes(b"orphan")
    want = js.gc(dry_run=True, min_age_s=0)
    got = ts.gc(dry_run=True, min_age_s=0)
    assert got == want and got["pruned"] == [orphan]
    assert ts.gc(min_age_s=0)["pruned"] == [orphan] and not ts.has_blob(orphan)


def test_publish_resolve_pin_and_integrity_match_jax(pipelines, tmp_path):
    jpipe, tpipe = pipelines
    reg = treg.ModelRegistry(str(tmp_path / "store"))
    pub = reg.publish("text", tpipe, metrics={"auc": 0.9})
    jpub = jreg.ModelRegistry(str(tmp_path / "jstore")).publish("text", jpipe)
    assert pub.version == "v1" and sorted(pub.manifest) == sorted(jpub.manifest)
    assert pub.manifest["stages"] == ["synapseml_torch.core.pipeline.PipelineModel",
                                      "_torch_serving_stages.TextsIn",
                                      "synapseml_torch.models.text.DeepTextModel",
                                      "_torch_serving_stages.ScoresOut"]
    fw = pub.manifest["framework"]
    assert fw["torch"] == torch.__version__ and fw["device"] == "cpu" and "jax" not in fw
    assert reg.publish("text", tpipe).version == "v2"
    with pytest.raises(FileExistsError):
        reg.publish("text", tpipe, version="v1")
    assert reg.aliases("text") == {"latest": "v2"}
    assert reg.pin("text", "prod", "v1") == "v1"
    resolved = reg.resolve("text", "prod")
    assert (resolved.version, resolved.name) == ("v1", "text")
    # the schema hash of a saved tree: the port's function is the JAX one
    assert treg.param_schema_hash(resolved.path) == jreg.param_schema_hash(resolved.path)
    assert treg.param_schema_hash(resolved.path) == pub.manifest["param_schema_sha256"]
    rows = [{"id": f"r{i}", "body": b} for i, b in enumerate(request_bodies(6, seed=1))]
    want = tpipe.transform(DataFrame.from_rows(rows)).collect_column("reply")
    got = resolved.stage.transform(DataFrame.from_rows(rows)).collect_column("reply")
    assert list(got) == list(want)
    # the JAX registry reads the port's store: versions, aliases, manifests
    jview = jreg.ModelRegistry(str(tmp_path / "store"))
    assert jview.list_versions("text") == ["v1", "v2"]
    assert jview.manifest("text", "prod") == reg.manifest("text", "v1")
    # a corrupt blob surfaces on a fresh materialization
    fresh = treg.ModelRegistry(str(tmp_path / "store"), cache_dir=str(tmp_path / "cache2"))
    big = max(pub.manifest["files"], key=lambda e: e["bytes"])
    with open(reg._store.blob_path(big["sha256"]), "r+b") as f:
        f.write(b"\xff\xff")
    with pytest.raises(tstore.IntegrityError):
        fresh.resolve("text", "v1")
    with pytest.raises(KeyError, match="neither a version nor an alias"):
        reg.resolve("text", "canary")
    with pytest.raises(treg.RegistryReadOnlyError):
        treg.ModelRegistry("http://127.0.0.1:9").publish("text", tpipe)


def test_publish_records_no_executables_and_load_warms_up(pipelines, tmp_path):
    _, tpipe = pipelines
    root = str(tmp_path / "store")
    reg = treg.ModelRegistry(root)
    rows = request_bodies(3, seed=2)
    pub = reg.publish("text", tpipe, aot={"rows": rows, "buckets": [8, 16]},
                      autotune={"trials": 1})
    sec = pub.manifest["aot"]
    assert sec["mechanism"] is None and sec["entries"] == [] and sec["total_bytes"] == 0
    assert sec["warmup"] == {"rows": rows, "buckets": [8, 16]}
    assert sec["runtime"] == taot.runtime_fingerprint()
    blobs = os.listdir(os.path.join(root, "blobs"))
    assert sorted(blobs) == sorted({e["sha256"] for e in pub.manifest["files"]})
    tune = pub.manifest["autotune"]
    assert tune["platform"] == "cpu" and tune["winners"]["attn_impl"] in ("einsum", "flash")
    assert sorted(tune["timings_ms"]["attn_impl"]) == ["einsum", "flash"]
    assert sorted(tune["timings_ms"]["attn_impl"]["flash"]) == ["16", "8"]
    srv = serve_pipeline(tpipe, batch_interval_ms=5, version="v0")
    try:
        status, _, data = request(srv.address, "POST", "/admin/load",
                                  {"registry": root, "model": "text", "ref": "v1",
                                   "warmup": rows}, timeout=120)
        reply = json.loads(data)
        assert status == 200 and reply["version"] == "v1" and reply["previous"] == "v0"
        wu = reply["warmup"]
        assert wu["mode"] == "jit" and wu["fallback_reason"] is None
        assert wu["rows"] == 8 + 16 + 32 + 64 + 3  # the body's rows up the small rungs
        assert wu["executables_traced"] > 0 and wu["executables_loaded"] == 0
        assert wu["autotune"] == [{"stage": "DeepTextModel", "param": "attn_impl",
                                   "from": None, "to": tune["winners"]["attn_impl"]}]
        served = srv.pipeline_holder.pipeline.get("stages")[1]
        assert served.get("attn_impl") == tune["winners"]["attn_impl"]
        body = request_bodies(1, seed=9)[0]
        status, _, data = request(srv.address, "POST", "/", body)
        direct = tpipe.transform(DataFrame.from_rows([{"id": "x", "body": body}]))
        np.testing.assert_allclose(np.asarray(json.loads(data)["scores"]),
                                   np.asarray(direct.collect_column("reply")[0]["scores"]),
                                   atol=1e-5)
        snap = tobs.get_registry().snapshot()
        assert snap["synapseml_deploy_warmup_compile_ms"]["count"] >= 1
        assert json.loads(request(srv.address, "GET", "/admin/stats")[2])["swap"] == wu
    finally:
        srv.stop()


def test_jax_manifest_with_aot_entries_falls_back_to_warmup(pipelines, tmp_path, caplog):
    from _aot_pipeline import build_pipeline, sample_rows

    _, tpipe = pipelines
    jroot, root = str(tmp_path / "jstore"), str(tmp_path / "store")
    jpub = jreg.ModelRegistry(jroot).publish("mlp", build_pipeline(), version="v1",
                                             aot={"rows": sample_rows(), "buckets": [8]})
    jsec = jpub.manifest["aot"]
    assert jsec["entries"] and jsec["mechanism"] in ("xla", "export")
    # the port's artifact with the JAX package's aot section and blobs
    reg = treg.ModelRegistry(root)
    pub = reg.publish("text", tpipe, version="v1")
    store = tstore.ArtifactStore(root)
    man = {k: v for k, v in store.read_manifest("text", "v1").items() if k != "signature"}
    man["aot"] = jsec
    for e in jsec["entries"]:
        shutil.copy(os.path.join(jroot, "blobs", e["sha256"]), store.blob_path(e["sha256"]))
    store.write_manifest("text", "v1", man)
    assert taot.load_blocker(jsec) == ("this runtime has no executable-serialization support"
                                       if jsec["mechanism"] == "export" else
                                       "artifact uses the 'xla' mechanism but this runtime "
                                       "supports None")
    key = 'synapseml_deploy_aot_fallbacks_total{reason="unsupported"}'
    before = tobs.get_registry().snapshot().get(key, 0)
    srv = serve_pipeline(tpipe, batch_interval_ms=5, version="v0")
    try:
        with caplog.at_level(logging.WARNING, logger="synapseml_torch.registry.aot"):
            status, _, data = request(srv.address, "POST", "/admin/load",
                                      {"registry": root, "model": "text", "ref": "v1",
                                       "warmup": request_bodies(2, seed=4)}, timeout=120)
        reply = json.loads(data)
        assert status == 200 and reply["ok"] and pub.version == reply["version"]
        wu = reply["warmup"]
        assert wu["mode"] == "jit" and wu["fallback_reason"] == taot.load_blocker(jsec)
        assert wu["executables_loaded"] == 0 and wu["rows"] > 0
        warned = [json.loads(r.message) for r in caplog.records
                  if r.name == "synapseml_torch.registry.aot"]
        assert [w["event"] for w in warned] == ["aot_fallback"]
        assert warned[0]["action"] == "JIT warmup (swap proceeds)"
        assert tobs.get_registry().snapshot()[key] == before + 1
        status, _, data = request(srv.address, "POST", "/", {"texts": ["good film"]})
        assert status == 200 and "scores" in json.loads(data)
    finally:
        srv.stop()
    # a provider over those entries serves none of them: each lookup demotes
    # to a build, with one warning an entry
    e = jsec["entries"][0]
    provider = taot.AOTExecutableSet(jsec, os.path.join(root, "blobs"))
    provider.begin_binding()
    assert provider.lookup(e["fn_id"], "tok", tuple(e["shape"]), e["dtype"]) is None
    assert provider.lookup("other", "tok", (1,), None) is None
    provider.freeze()
    assert provider.report()["aot_errors"] == 1 and provider.report()["aot_misses"] == 1
    assert taot.aot_key_digest(e["fn_id"], e["shape"], e["dtype"]) == e["key"]
    assert taot.aot_key_digest("f", (8, 16), "int32") == jaot.aot_key_digest("f", [8, 16],
                                                                            "int32")


def _copied(pipe):
    pipe = pipe.copy()
    pipe.set(stages=[s.copy() for s in pipe.get("stages")])
    return pipe


def test_registry_load_without_rows_replays_no_recorded_rows(pipelines, tmp_path):
    """With no ``aot.entries`` a load replays no recorded rows (the JAX
    server's rule): the body's rows are the warmup."""
    _, tpipe = pipelines
    root = str(tmp_path / "store")
    treg.ModelRegistry(root).publish("text", tpipe, aot={"rows": request_bodies(2, seed=2),
                                                         "buckets": [8]})
    srv = serve_pipeline(tpipe, batch_interval_ms=5, version="v0")
    try:
        status, _, data = request(srv.address, "POST", "/admin/load",
                                  {"registry": root, "model": "text", "ref": "v1"}, timeout=120)
        wu = json.loads(data)["warmup"]
        assert status == 200 and wu["rows"] == 0 and wu["executables_traced"] == 0
    finally:
        srv.stop()


def test_autotune_on_the_card_times_the_plain_attention_and_pins_flash(pipelines):
    loop = {"parse_json": True, "input_col": "body"}
    tpipe = _copied(pipelines[1])
    got = ttune.autotune_stage(tpipe, request_bodies(2, seed=1), [8, 16], loop, trials=1,
                               platform="cuda")
    assert got["platform"] == "cuda" and got["baseline"] == {"attn_impl": "einsum"}
    assert sorted(got["timings_ms"]["attn_impl"]) == ["einsum", "flash"]
    assert got["winners"] == {"attn_impl": "flash"}
    assert got["per_rung"]["attn_impl"] == {"8": "flash", "16": "flash"}
    assert tpipe.get("stages")[1].get("attn_impl") == "flash"
    fresh = _copied(pipelines[1])
    assert ttune.apply_autotune(fresh, got, platform="cuda") == [
        {"stage": "DeepTextModel", "param": "attn_impl", "from": None, "to": "flash"}]


def test_autotune_on_the_card_raises_a_failing_kernel(pipelines, monkeypatch):
    """Off the card a candidate that fails loses, as in the JAX search; on
    the card the failure of the hand-written kernel is raised."""
    from synapseml_torch.models.nets import transformer

    def broken(*args, **kwargs):
        raise RuntimeError("flash kernel failed to launch")

    monkeypatch.setattr(transformer, "flash_attention", broken)
    loop = {"parse_json": True, "input_col": "body"}
    rows = request_bodies(2, seed=1)
    tpipe = _copied(pipelines[1])
    got = ttune.autotune_stage(tpipe, rows, [8], loop, trials=1, platform="cpu")
    assert got["winners"] == {"attn_impl": "einsum"} and "baseline" not in got
    assert "flash kernel failed to launch" in got["errors"]["attn_impl"]["flash"]
    tpipe = _copied(pipelines[1])
    with pytest.raises(RuntimeError, match="flash kernel failed to launch"):
        ttune.autotune_stage(tpipe, rows, [8], loop, trials=1, platform="cuda")
    assert tpipe.get("stages")[1].get("attn_impl") is None  # the stage's own value


def test_apply_autotune_pins_what_the_jax_one_pins(pipelines):
    jpipe, tpipe = (_copied(p) for p in pipelines)
    assert [(type(s).__name__, p, c) for s, p, c in ttune.tunable_params(tpipe)] == \
        [(type(s).__name__, p, c) for s, p, c in jtune.tunable_params(jpipe)] == \
        [("DeepTextModel", "attn_impl", ("einsum", "flash"))]
    section = {"platform": "cpu", "winners": {"attn_impl": "flash", "histogram_impl": "onehot"}}
    for tsec, plat in ((section, "cpu"), (section, None), ({**section, "platform": "tpu"}, "cpu"),
                       ({}, "cpu")):
        got = ttune.apply_autotune(tpipe, tsec, platform=plat)
        want = jtune.apply_autotune(jpipe, tsec, platform=plat or "cpu")
        assert got == want
    assert ttune.apply_autotune(tpipe, section, platform="cpu") == []  # already pinned
    assert tpipe.get("stages")[1].get("attn_impl") == "flash"
    rows = [{"id": "r", "body": b} for b in request_bodies(3, seed=8)]
    np.testing.assert_allclose(
        np.asarray(tpipe.transform(DataFrame.from_rows(rows)).collect_column("reply")[0]
                   ["scores"]),
        np.asarray(jpipe.transform(JDataFrame.from_rows(rows)).collect_column("reply")[0]
                   ["scores"]), atol=1e-5)
    # the search with a bench-fed override: both record the same structure
    loop = {"parse_json": True, "input_col": "body"}
    got = ttune.autotune_stage(tpipe, request_bodies(2, seed=1), [8], loop, trials=1,
                               winners={"histogram_impl": "onehot"}, platform="cpu")
    want = jtune.autotune_stage(jpipe, request_bodies(2, seed=1), [8], loop, trials=1,
                                winners={"histogram_impl": "onehot"}, platform="cpu")
    assert sorted(got) == sorted(want) and got["winners"]["histogram_impl"] == "onehot"
    assert sorted(got["timings_ms"]["attn_impl"]) == ["einsum", "flash"]
    assert got["per_rung"]["attn_impl"]["8"] in ("einsum", "flash")
