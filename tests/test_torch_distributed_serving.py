"""synapseml_torch's serve_pipeline_distributed against the JAX package's.

Each package serves the bert-tiny text-scoring pipeline of
``_torch_serving_stages`` (f32, the same weights bridged with
``convert_jax``) on two worker processes behind its routing front; the
deployments start once for the module. The same request bodies go to both
fronts: the replies carry the same status codes and keys, the same
predictions and scores within 1e-5, and both of the port's workers answer.
Then, on the port: HTTP/1.1 keep-alive through the front, ``/routes`` and
``RoutingClient``; ``collect_distributed_trace`` stitching one trace over
the front and the workers; a worker SIGKILLed once it has answered a count
of requests while traffic runs: no request fails, its breaker opens, the
supervisor respawns it and the replacement registers and serves. A pickled
port pipeline carries its weights once and no device-bound state, and a
worker whose stage names the card raises on a host without one.
"""

import json
import os
import pickle
import pickletools
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_serving_stages import JTextPipeline, request, request_bodies, serving_pipelines
from _torch_worker_stages import ScoresOut, TextsIn
from synapseml_torch.core import observability as tobs
from synapseml_torch.core.pipeline import PipelineModel
from synapseml_torch.core.dataframe import DataFrame
from synapseml_torch.io import distributed_serving as tds
from synapseml_tpu.io import distributed_serving as jds

TOL = 1e-5
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline); the port's request adapters from
    ``_torch_worker_stages``, which a worker imports without the JAX
    package."""
    jpipe, tpipe = serving_pipelines()
    return jpipe, PipelineModel(stages=[TextsIn(), tpipe.get("stages")[1], ScoresOut()])


@pytest.fixture(scope="module")
def handles(pipelines):
    """(JAX deployment, port deployment), two workers each. The workers
    find the tests' stage modules on PYTHONPATH and run one torch thread."""
    jpipe, tpipe = pipelines
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", os.pathsep.join([TESTS, os.environ.get("PYTHONPATH", "")]))
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("JAX_PLATFORMS", "cpu")
        try:
            out.append(jds.serve_pipeline_distributed(JTextPipeline(stages=jpipe.get("stages")),
                                                      num_workers=2, batch_interval_ms=5,
                                                      startup_timeout_s=120, version="v1"))
            out.append(tds.serve_pipeline_distributed(tpipe, num_workers=2, batch_interval_ms=5,
                                                      startup_timeout_s=120, version="v1",
                                                      coalesce_window_ms=2.0))
            yield out
        finally:
            for h in out:
                h.stop()


def _post(base, body, path="/"):
    status, hdrs, data = request(base, "POST", path, body, timeout=60)
    return status, json.loads(data), hdrs


def _same_reply(got, want):
    assert got.keys() == want.keys()
    if "scores" in want:
        assert got["prediction"] == want["prediction"]
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL, rtol=0)
    else:
        assert got == want


def _fire(base, bodies, threads=4):
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda b: _post(base, b), bodies))


def test_replies_match_jax_and_both_workers_answer(handles):
    jh, th = handles
    bodies = request_bodies(32, seed=3, bad_every=8)
    want, got = _fire(jh.address, bodies), _fire(th.address, bodies)
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (_, g, _), (_, w, _) in zip(got, want):
        _same_reply(g, w)
    served = {h["X-Served-By"] for _, _, h in got}
    assert served == {str(p.pid) for p in th.procs}
    assert {h["X-Served-Version"] for _, _, h in got} == {"v1"}


def test_keepalive_routes_and_routing_client(handles):
    import http.client

    jh, th = handles
    bodies = request_bodies(6, seed=4)
    host, port = th.address.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    pids, replies = set(), []
    for b in bodies:  # one persistent client connection, many requests
        conn.request("POST", "/", body=json.dumps(b).encode())
        r = conn.getresponse()
        assert r.status == 200
        pids.add(r.getheader("X-Served-By"))
        replies.append(json.loads(r.read()))
    conn.close()
    assert len(pids) == 2
    table = json.loads(request(th.address, "GET", "/routes")[2])
    assert sorted(w["pid"] for w in table) == sorted(p.pid for p in th.procs)
    assert all(w["version"] == "v1" for w in table)
    client = tds.RoutingClient(front_address=th.address)
    try:
        direct = [client.request("/", body=json.dumps(b).encode()) for b in bodies]
    finally:
        client.close()
    for (status, payload), want, b in zip(direct, replies, bodies):
        assert status == 200
        _same_reply(json.loads(payload), want)
        _same_reply(json.loads(payload), _post(jh.address, b)[1])


@pytest.mark.chaos(timeout_s=60)
def test_distributed_trace_stitches_across_processes(handles):
    _, th = handles
    t = tobs.get_tracer()
    with t.span("client.request") as cs:
        headers = t.inject({})
        status, _, _ = request(th.address, "POST", "/", request_bodies(1, seed=5)[0],
                               headers=headers)
    assert status == 200
    deadline = time.monotonic() + 10
    while True:  # the front's span closes a hair after the reply's bytes
        spans = tds.collect_distributed_trace(th.address)
        ours = [s for s in spans if s["trace_id"] == cs.trace_id]
        names = {s["name"] for s in ours}
        if {"client.request", "route.request", "serving.request"} <= names \
                or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    route = next(s for s in ours if s["name"] == "route.request")
    serving = next(s for s in ours if s["name"] == "serving.request")
    assert route["parent_id"] == cs.span_id and serving["parent_id"] == route["span_id"]
    assert len({s["pid"] for s in ours}) >= 2
    doc = json.loads(json.dumps(tobs.chrome_trace_events(ours)))
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} >= {
        "client.request", "route.request", "serving.request"}
    front_text = request(th.address, "GET", "/metrics")[2].decode()
    assert "synapseml_route_request_duration_ms_bucket" in front_text
    assert "synapseml_breaker_state{" in front_text and "synapseml_route_pick_ms" in front_text
    for w in json.loads(request(th.address, "GET", "/routes")[2]):
        text = request(f"http://{w['host']}:{w['port']}", "GET", "/metrics")[2].decode()
        assert "synapseml_serving_request_duration_ms_bucket" in text


def test_coalesce_window_needs_micro_batch_workers(pipelines):
    for ds, pipe in zip((jds, tds), pipelines):
        with pytest.raises(ValueError, match="micro-batch"):
            ds.serve_pipeline_distributed(pipe, num_workers=1, batch_interval_ms=0,
                                          coalesce_window_ms=5.0)


def test_pickled_stage_carries_its_weights_once_and_no_device_state(pipelines):
    _, tpipe = pipelines
    model = tpipe.get("stages")[1]
    texts = DataFrame.from_dict({"text": np.asarray(["good film", "not very bad"], dtype=object)})
    weights = sum(np.asarray(v).nbytes for v in model.get("model_params").values())
    before = pickle.dumps(tpipe)
    want = np.stack(list(model.transform(texts).collect_column("scores")))
    assert model._module is not None  # built, cached, and on the stage
    after = pickle.dumps(tpipe)
    assert len(after) == len(before) < 1.05 * weights
    # the torch objects it names are the config's dtypes: no tensor, no storage
    strings = [arg for op, arg, _ in pickletools.genops(after)
               if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE")]
    named = {(m, n) for m, n in zip(strings, strings[1:]) if m.split(".")[0] == "torch"}
    assert named and all(m == "torch" and isinstance(getattr(torch, n), torch.dtype)
                         for m, n in named), named
    again = pickle.loads(after).get("stages")[1]
    assert again._module is None and "_compiled_cache_token" not in again.__dict__
    got = np.stack(list(again.transform(texts).collect_column("scores")))
    np.testing.assert_array_equal(got, want)
    assert model._module is not None  # pickling left the live stage as it was


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a CUDA card")
def test_a_worker_on_a_host_without_a_card_raises(pipelines, tmp_path):
    """The default device names the card: a worker raises before it serves
    or registers, for a pickled pipeline and for the LLM worker."""
    _, tpipe = pipelines
    on_card = pickle.loads(pickle.dumps(tpipe))
    on_card.get("stages")[1].set(device="cuda")
    path = str(tmp_path / "pipeline.pkl")
    with open(path, "wb") as f:
        pickle.dump(on_card, f)
    registry = tds.WorkerRegistry()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(TESTS), TESTS, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    codes = [f"worker_main({path!r}, {registry.address + '/register'!r}, 5)",
             f"llm_worker_main('llama-tiny', {registry.address + '/register'!r})"]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"from synapseml_torch.io.distributed_serving import *; {code}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for code in codes]
        outs = [p.communicate(timeout=120) for p in procs]
        assert [p.returncode for p in procs] != [0, 0] and all(p.returncode for p in procs)
        for out, err in outs:
            assert b"has no CUDA device" in err and b"ready" not in out
        assert registry.workers() == []
    finally:
        registry.close()


@pytest.mark.chaos(timeout_s=90)
def test_sigkill_a_worker_under_traffic_then_it_rejoins(handles):
    """SIGKILL one port worker once it has answered 8 requests, while four
    clients keep sending: every request is answered 200 with the JAX
    front's reply, the victim's breaker opens, the supervisor respawns the
    worker and the replacement registers and takes traffic."""
    jh, th = handles
    victim = th.procs[0]
    endpoint = next(f"{w['host']}:{w['port']}" for w in th.registry.workers()
                    if w["pid"] == victim.pid)
    bodies = request_bodies(96, seed=6)
    want = _fire(jh.address, bodies)
    answered, killed = [0], threading.Event()
    lock = threading.Lock()

    def send(b):
        got = _post(th.address, b)
        if got[2].get("X-Served-By") == str(victim.pid):
            with lock:
                answered[0] += 1
                if answered[0] == 8:
                    os.kill(victim.pid, signal.SIGKILL)
                    killed.set()
        return got

    failures = tobs.get_registry().counter(
        "synapseml_route_worker_failures_total", "forward attempts that failed, per worker",
        ("worker",)).labels(worker=endpoint)
    failed0 = failures.value
    opens0 = json.loads(request(th.address, "GET", "/stats")[2])["resilience"][
        "breaker_open_count"]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(send, bodies))
    assert killed.is_set()
    assert [s for s, _, _ in got] == [200] * len(bodies)
    for (_, g, _), (_, w, _) in zip(got, want):
        _same_reply(g, w)
    stats = json.loads(request(th.address, "GET", "/stats")[2])
    # the victim is out of the rotation: a forward that reached it opened
    # its breaker; none reaches it once the supervisor has dropped it
    if failures.value > failed0:
        assert stats["resilience"]["breaker_open_count"] > opens0
    assert stats["breakers"].get(endpoint, "open") == "open"
    deadline = time.monotonic() + 60
    fresh = set()
    while time.monotonic() < deadline and not fresh:
        pids = {w["pid"] for w in th.registry.workers()}
        fresh = pids - {victim.pid, th.procs[1].pid}
        time.sleep(0.1)
    assert fresh, "the supervisor never respawned the worker"
    later = _fire(th.address, bodies[:24])
    assert {h["X-Served-By"] for _, _, h in later} == {str(p) for p in pids}
    for (_, g, _), (_, w, _) in zip(later, want):
        _same_reply(g, w)
