"""synapseml_torch's serve_pipeline against the JAX package's.

One process runs both servers, each serving bert-tiny ``DeepTextModel``
(f32, the same weights bridged with ``convert_jax``) between the request
adapters of ``_torch_serving_stages.py``; the same request bodies go to
both. Replies carry the same status codes and JSON keys and scores within
1e-5, in micro-batch and continuous mode. The admin and observability
endpoints answer alike; a hot swap by path warms the replacement so the
first request after it takes no cache miss, releases the old pipeline's
entries, and fails (409, serving on) for a bad load; a drain refuses new
requests with the JAX server's 503.
"""

import json
import threading

import numpy as np
import pytest
import torch

from _torch_serving_stages import request, request_bodies, serving_pipelines
from synapseml_torch.core import batching as tcb
from synapseml_torch.core import observability as tobs
from synapseml_torch.core.serialization import save_stage
from synapseml_torch.io import serving as tsrv
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core.serialization import save_stage as jsave_stage
from synapseml_tpu.io import serving as jsrv

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipelines():
    return serving_pipelines()


@pytest.fixture()
def servers(pipelines, request_mode):
    """(JAX server, port server) over the module's pipelines."""
    jpipe, tpipe = pipelines
    srvs = []
    try:
        for serve, pipe in ((jsrv.serve_pipeline, jpipe), (tsrv.serve_pipeline, tpipe)):
            srvs.append(serve(pipe, batch_interval_ms=request_mode, version="v1"))
        yield srvs
    finally:
        for s in srvs:
            s.stop()


@pytest.fixture()
def request_mode():
    return 10  # micro-batch; tests parametrize it


def _send_all(base, bodies, threads=4):
    """Every body POSTed from ``threads`` clients at once: (status, reply)
    per body, in order."""
    out = [None] * len(bodies)

    def client(k):
        for i in range(k, len(bodies), threads):
            status, _, data = request(base, "POST", "/", bodies[i])
            out[i] = (status, json.loads(data) if data else None)

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert all(o is not None for o in out)
    return out


def _assert_same_replies(got, want):
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws == 200
        assert sorted(g) == sorted(w)
        if "scores" in w:
            np.testing.assert_allclose(np.asarray(g["scores"]), np.asarray(w["scores"]),
                                       atol=TOL)
            assert g["prediction"] == w["prediction"]
        else:
            assert g == w


@pytest.mark.parametrize("request_mode", [10, 0], ids=["micro-batch", "continuous"])
def test_replies_match_jax(servers, request_mode):
    jserver, tserver = servers
    bodies = request_bodies(30, seed=request_mode, bad_every=9)
    want = _send_all(jserver.address, bodies)
    got = _send_all(tserver.address, bodies)
    _assert_same_replies(got, want)
    assert sum("error" in r for _, r in got) == 3
    # a body that is not JSON parses to None: an error reply, as the JAX one
    raw = [request(s.address, "POST", "/", b"{not json") for s in servers]
    assert [r[0] for r in raw] == [200, 200] and raw[0][2] == raw[1][2]


def test_admin_and_observability_endpoints_match_jax(servers):
    jserver, tserver = servers
    for obs in (tobs, jobs):  # the series of this test's traffic alone
        obs.reset_registry()
    tobs.get_tracer().clear()
    bodies = request_bodies(8, seed=3)
    _send_all(jserver.address, bodies, threads=2)
    _send_all(tserver.address, bodies, threads=2)
    for path in ("/admin/version", "/admin/stats"):
        (js, _, jd), (ts, _, td) = (request(s.address, "GET", path) for s in servers)
        assert js == ts == 200
        assert sorted(json.loads(td)) == sorted(json.loads(jd))
    assert json.loads(request(tserver.address, "GET", "/admin/version")[2]) == \
        {"version": "v1", "pipeline": "PipelineModel"}
    # /metrics: Prometheus text with the JAX server's serving series
    series = []
    for s in servers:
        status, headers, data = request(s.address, "GET", "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        names = set()
        for line in data.decode().splitlines():
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(" ")
                assert kind in ("counter", "gauge", "histogram")
            elif line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
                names.add(name.split("{")[0])
        series.append({n for n in names if n.startswith("synapseml_serving_")})
    assert series[0] == series[1] and "synapseml_serving_request_duration_ms_bucket" in series[1]
    # /trace: a request's span joins the trace of the traceparent it carried
    parent = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    status, _, _ = request(tserver.address, "POST", "/", bodies[0],
                           headers={"traceparent": parent})
    spans = json.loads(request(tserver.address, "GET", "/trace")[2])
    served = [s for s in spans if s["name"] == "serving.request"
              and s["trace_id"] == "4bf92f3577b34da6a3ce929d0e0e4736"]
    assert status == 200 and len(served) == 1
    assert served[0]["parent_id"] == "00f067aa0ba902b7"
    assert served[0]["attributes"] == {"path": "/", "method": "POST"}


def test_hot_swap_by_path_warms_and_releases(servers, pipelines, tmp_path):
    jpipe, tpipe = pipelines
    jserver, tserver = servers
    save_stage(tpipe, str(tmp_path / "tv2"))
    jsave_stage(jpipe, str(tmp_path / "jv2"))
    warm = request_bodies(4, seed=5)
    bodies = request_bodies(12, seed=6)
    cache = tcb.get_compiled_cache()
    old_model = tserver.pipeline_holder.pipeline.get("stages")[1]
    old_token = tcb.instance_token(old_model)
    before = _send_all(tserver.address, bodies)
    assert [k for k in cache._entries if k[1] == old_token]
    replies = []
    for s, d in ((jserver, "jv2"), (tserver, "tv2")):
        replies.append(request(s.address, "POST", "/admin/load",
                               {"path": str(tmp_path / d), "warmup": warm,
                                "warmup_buckets": [8, 16, 32]}, timeout=120))
    (js, _, jd), (ts, _, td) = replies
    assert js == ts == 200
    jr, tr = json.loads(jd), json.loads(td)
    assert sorted(tr) == sorted(jr) and sorted(tr["warmup"]) == sorted(jr["warmup"])
    assert tr["version"] == "tv2" and tr["previous"] == "v1"
    assert tr["warmup"]["mode"] == "jit" and tr["warmup"]["executables_traced"] > 0
    assert tr["warmup"]["rows"] == jr["warmup"]["rows"] == 8 + 16 + 32 + 4
    new_model = tserver.pipeline_holder.pipeline.get("stages")[1]
    assert new_model is not old_model
    assert not [k for k in cache._entries if k[1] == old_token]  # released
    misses = cache.miss_count("deep_text_model")
    status, _, data = request(tserver.address, "POST", "/", request_bodies(1, seed=7)[0])
    assert status == 200 and "scores" in json.loads(data)
    assert cache.miss_count("deep_text_model") == misses  # warmed: no miss
    after = _send_all(tserver.address, bodies)
    _assert_same_replies(after, before)  # the same weights from disk
    _assert_same_replies(after, _send_all(jserver.address, bodies))
    # a load that fails keeps the old pipeline serving: 409, as the JAX one
    for body in ({"path": str(tmp_path / "missing")}, {"model": "x"}, b"{bad"):
        codes = [request(s.address, "POST", "/admin/load", body)[0] for s in servers]
        assert codes[0] == codes[1] and codes[1] in (400, 409)
    assert request(tserver.address, "GET", "/admin/version")[2] == \
        json.dumps({"version": "tv2", "pipeline": "PipelineModel"}).encode()


def test_drain_refuses_new_requests_as_jax(servers):
    drained = {}
    for s in servers:
        s.on_drained = lambda report, s=s: drained.setdefault(s.port, report)
    codes = []
    for s in servers:
        status, _, data = request(s.address, "POST", "/admin/drain", {"timeout_s": 5})
        reply = json.loads(data)
        assert status == 200 and reply["draining"] and not reply["already_draining"]
        status, headers, data = request(s.address, "POST", "/", {"texts": ["late"]})
        codes.append((status, headers.get("Retry-After"), json.loads(data)))
        assert json.loads(request(s.address, "GET", "/admin/stats")[2])["draining"]
    assert codes[0] == codes[1] == (503, "1", {"error": "worker draining"})
    for _ in range(200):
        if len(drained) == 2:
            break
        threading.Event().wait(0.05)
    assert sorted(r["outcome"] for r in drained.values()) == ["ok", "ok"]
