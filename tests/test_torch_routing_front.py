"""synapseml_torch's RoutingFront and RoutingClient against the JAX package's.

The workers are in-process stub HTTP servers that answer with their own
name, so a reply says which worker served it. Each case runs the same
traffic through the JAX package's front and through the port's, over the
same stubs or over fresh stubs bound to the same ports (the rendezvous
orderings hash the endpoint), with each package's
``distributed_serving`` resilience counters reset first, and asserts the
same record: the serving worker of every request, statuses and headers,
breaker states, ``/stats`` (resilience counters, breakers, split, shadow,
per-version ok/err/shed/in-flight and admission counters; the latency
percentiles are wall clock and left out), shed decisions, retrieval
fan-out replies and the request logger's calls. Everything here is host
code, so records are held equal, with no tolerance.

Covered: dead marking and ``/stats``; time-based resurrection; all-dead
probing of the least-recently-failed worker; registry refresh with breaker
pruning; the client's breaker; two of three workers killed (on a request
count, not a sleep) and resurrected; the coalescer; front metrics, the
``/metrics`` GET gate and ``traceparent`` stitching; canary split, shadow
traffic and ``/admin/split``; admission shedding on the wire; prefix
routing; the retrieval fan-out with a dead holder (``X-Retrieval-Partial``);
the client label cap; the draining worker's reroute; the request-logger
hook.
"""

import difflib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from synapseml_torch import fleet as tfleet
from synapseml_torch.core import observability as tobs
from synapseml_torch.core import resilience as tres
from synapseml_torch.io import distributed_serving as tds
from synapseml_torch.retrieval.metrics import retrieval_metrics
from synapseml_tpu import fleet as jfleet
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core import resilience as jres
from synapseml_tpu.io import distributed_serving as jds

PKGS = {"jax": (jds, jres, jobs, jfleet), "torch": (tds, tres, tobs, tfleet)}
DRAINING = b'{"error": "worker draining"}'


class _StubHandler(BaseHTTPRequestHandler):
    # HTTP/1.0: a connection closes after its reply, so a stopped stub is
    # gone for the front (no pooled connection keeps reaching it)

    def log_message(self, *a):
        pass

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        status, reply = self.server.behave(self.path, body, self.headers)
        data = reply if isinstance(reply, bytes) else json.dumps(reply).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = _answer


class Stub(ThreadingHTTPServer):
    """A worker that answers ``{"worker": name, "path", "body", "tp"}``
    (``tp``: the traceparent it was sent), or its ``status``/``payload``
    when set; a shard holder answers ``/m/<index>`` sub-queries."""

    daemon_threads = True
    # a deep accept queue: under load a full one (socketserver's 5) drops
    # SYNs, and a connect that waits out three retransmits (7 s) fails
    request_queue_size = 128

    def __init__(self, name: str, port: int = 0, version=None, shards=None):
        super().__init__(("127.0.0.1", port), _StubHandler)
        self.name, self.version, self.shards = name, version, shards
        self.status, self.payload = 200, None
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def info(self, pid: int = 0) -> dict:
        w = {"host": "127.0.0.1", "port": self.port, "pid": pid}
        if self.version is not None:
            w["version"] = self.version
        if self.shards is not None:
            w.update(model="idx", shards=list(self.shards))
        return w

    def behave(self, path, body, headers):
        if self.payload is not None:
            return self.status, self.payload
        if self.shards is not None and path.startswith("/m/"):
            req = json.loads(body)
            matches = [[{"id": 1000 * int(s[1:]) + j, "distance": round(
                abs(sum(q) - int(s[1:]) - 0.25 * j), 6), "shard": s}
                for s in req["shards"] for j in range(req["k"])] for q in req["queries"]]
            return 200, {"matches": matches}
        return self.status, {"worker": self.name, "path": path,
                             "body": json.loads(body or b"null"),
                             "tp": headers.get("traceparent")}

    def stop(self):
        self.shutdown()
        self.server_close()


class _Held:
    """A loopback port bound and not listening: a connect to it is refused,
    as to a dead worker's, and no other socket takes it until ``free()``,
    called just before a stub binds it (a port found free and left unbound
    can be another process's by then)."""

    def __init__(self, port: int = 0):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]

    def free(self) -> int:
        self._sock.close()
        return self.port


def _call(front, path="/", body=b"{}", headers=None, timeout=10):
    """(status, reply JSON or None, headers) of one POST through ``front``."""
    req = urllib.request.Request(front.address + path, data=body, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null"), dict(r.headers)
    except urllib.error.HTTPError as e:
        data = e.read()
        return e.code, json.loads(data) if data else None, dict(e.headers)


def _until_served(front, names, deadline_s: float = 10.0) -> bool:
    """Requests through ``front`` until each worker of ``names`` has answered
    one, under a deadline: True when all have, every answer a 200."""
    want, ok = set(names), True
    deadline = time.monotonic() + deadline_s
    while want and time.monotonic() < deadline:
        status, body, _ = _call(front)
        ok = ok and status == 200
        want.discard((body or {}).get("worker"))
        if want:
            time.sleep(0.05)
    return ok and not want


def _get(front, path):
    with urllib.request.urlopen(front.address + path, timeout=10) as r:
        return r.read()


def _names(stubs) -> dict:
    """``host:port`` -> stub name, for breaker tables."""
    return {f"127.0.0.1:{s.port}": s.name for s in stubs}


def _stats(front, names) -> dict:
    """``/stats`` without the wall-clock figures (latency percentiles, the
    counters' summed ms), endpoints by stub name; read once no request is
    in flight (the front counts one out after its reply is written)."""
    deadline = time.monotonic() + 5
    while True:
        stats = json.loads(_get(front, "/stats"))
        busy = any(n for v in stats["versions"].values() for n in v["inflight"].values())
        if not busy or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    stats["breakers"] = {names.get(k, k): v for k, v in stats["breakers"].items()}
    stats["resilience"].pop("total_ms")
    for v in stats["versions"].values():
        for key in ("p50_ms", "p95_ms"):
            v.pop(key, None)
    for model in (stats["admission"] or {}).values():
        model.pop("p99_ms")
    return stats


def _both(run):
    """``run(ds, res, obs, fleet)`` for the JAX package then the port, each
    with its ``distributed_serving`` counters reset; equal records."""
    got = []
    for pkg in PKGS.values():
        pkg[1].reset_resilience_measures("distributed_serving")
        got.append(run(*pkg))
    if got[0] != got[1]:
        jax_rec, port_rec = (json.dumps(g, indent=1, sort_keys=True, default=repr).splitlines()
                             for g in got)
        pytest.fail("the port's record differs from the JAX package's:\n" + "\n".join(
            difflib.unified_diff(jax_rec, port_rec, "jax", "port", lineterm="", n=2)))
    return got[1]


def test_dead_marking_and_stats():
    live, held = Stub("live"), _Held()
    dead = held.port
    names = {**_names([live]), f"127.0.0.1:{dead}": "dead"}

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([{"host": "127.0.0.1", "port": dead, "pid": 1}, live.info(2)],
                                timeout_s=5, resurrect_after_s=60)
        try:
            served = [(s, b["worker"], h.get("X-Served-By")) for s, b, h in
                      (_call(front) for _ in range(6))]
            return served, _stats(front, names)
        finally:
            front.close()

    try:
        served, stats = _both(run)
    finally:
        live.stop()
        held.free()
    assert served == [(200, "live", "2")] * 6
    assert stats["breakers"] == {"dead": "open", "live": "closed"}
    assert stats["resilience"]["breaker_open_count"] == 1
    assert stats["resilience"]["retry_count"] >= 1
    assert stats["versions"]["unversioned"]["ok"] == 6


def test_time_based_resurrection():
    def run(ds, res, obs, fleet):
        live, held = Stub("live"), _Held()
        port = held.port
        front = ds.RoutingFront([{"host": "127.0.0.1", "port": port, "pid": 1}, live.info(2)],
                                timeout_s=5, resurrect_after_s=0.3)
        revived = None
        try:
            first = [_call(front)[1]["worker"] for _ in range(4)]
            opened = front._breaker(("127.0.0.1", port)).state
            revived = Stub("revived", port=held.free())
            # past the resurrection window the half-open probe reaches it
            back = _until_served(front, ["revived"])
            seen = {_call(front)[1]["worker"] for _ in range(8)}
            return first, opened, back, sorted(seen), front._breaker(("127.0.0.1", port)).state
        finally:
            front.close()
            live.stop()
            if revived is not None:
                revived.stop()
            else:
                held.free()

    first, opened, back, seen, closed = _both(run)
    assert first == ["live"] * 4 and opened == "open" and back
    assert seen == ["live", "revived"] and closed == "closed"


def test_all_dead_probes_least_recently_failed():
    def run(ds, res, obs, fleet):
        held_a, held_b = _Held(), _Held()
        port_a, port_b = held_a.port, held_b.port
        front = ds.RoutingFront([{"host": "127.0.0.1", "port": port_a, "pid": 1},
                                 {"host": "127.0.0.1", "port": port_b, "pid": 2}],
                                timeout_s=2, resurrect_after_s=300)
        revived = None
        try:
            status = _call(front)[0]
            br_a = front._breaker(("127.0.0.1", port_a))
            br_b = front._breaker(("127.0.0.1", port_b))
            states = (br_a.state, br_b.state)
            br_a.last_failure_at = br_b.last_failure_at - 10.0  # A is the stalest failure
            revived = Stub("a", port=held_a.free())
            got = _call(front)
            return status, states, got[0], got[1]["worker"], br_a.state, br_b.state
        finally:
            front.close()
            held_b.free()
            if revived is not None:
                revived.stop()
            else:
                held_a.free()

    assert _both(run) == (503, ("open", "open"), 200, "a", "closed", "open")


def test_registry_refresh_routes_to_late_worker_and_prunes_breakers():
    def run(ds, res, obs, fleet):
        registry = ds.WorkerRegistry()
        front = ds.RoutingFront(registry=registry, timeout_s=5)
        srv, held = Stub("late"), _Held()
        ghost = held.port
        try:
            empty = _call(front)[0]

            def register(info):
                urllib.request.urlopen(urllib.request.Request(
                    registry.address + "/register", data=json.dumps(info).encode(),
                    method="POST"), timeout=10).read()

            register(srv.info(7))
            late = _call(front)
            register({"host": "127.0.0.1", "port": ghost, "pid": 8})
            statuses = [_call(front)[0] for _ in range(4)]
            tracked = ("127.0.0.1", ghost) in front._breakers
            registry.remove_pid(8)
            after = _call(front)[0]
            table = [w["pid"] for w in json.loads(_get(front, "/routes"))]
            return (empty, late[0], late[1]["worker"], statuses, tracked, after,
                    ("127.0.0.1", ghost) in front._breakers, table)
        finally:
            front.close()
            registry.close()
            srv.stop()
            held.free()

    assert _both(run) == (503, 200, "late", [200] * 4, True, 200, False, [7])


def test_routing_client_breaker_skips_dead_worker():
    live, held = Stub("live"), _Held()
    dead = held.port

    def run(ds, res, obs, fleet):
        client = ds.RoutingClient(workers=[live.info(1),
                                           {"host": "127.0.0.1", "port": dead, "pid": 2}],
                                  timeout_s=2, resurrect_after_s=300)
        try:
            got = [client.request("/", body=b"{}") for _ in range(6)]
            states = client.breaker_states()
            return ([(s, json.loads(p)["worker"]) for s, p in got],
                    {_names([live]).get(k, "dead"): v for k, v in states.items()})
        finally:
            client.close()

    try:
        got, states = _both(run)
    finally:
        live.stop()
        held.free()
    assert got == [(200, "live")] * 6 and states == {"live": "closed", "dead": "open"}


@pytest.mark.chaos(timeout_s=60)
def test_kill_two_of_three_then_resurrect():
    """Two of three workers go down once the front has answered 12
    requests, and come back on their ports: every request of the three
    phases is answered 200, the survivor carries the middle phase, and all
    three serve again after."""
    def run(ds, res, obs, fleet):
        servers = [Stub(f"w{i}") for i in range(3)]
        front = ds.RoutingFront([s.info(i) for i, s in enumerate(servers)],
                                timeout_s=5, resurrect_after_s=0.3)
        revived = []
        try:
            before = [_call(front) for _ in range(12)]
            held = []
            for s in servers[:2]:  # each port held down from its server's stop
                s.stop()
                held.append(_Held(s.port))
            during = [_call(front) for _ in range(12)]
            revived = [Stub(f"w{i}", port=h.free()) for i, h in enumerate(held)]
            back = _until_served(front, ["w0", "w1"])
            after = [_call(front) for _ in range(24)]
            opens = json.loads(_get(front, "/stats"))["resilience"]["breaker_open_count"]
            return ([s for s, _, _ in before + during + after],
                    sorted({b["worker"] for _, b, _ in before}),
                    {b["worker"] for _, b, _ in during}, back,
                    sorted({b["worker"] for _, b, _ in after}), opens)
        finally:
            front.close()
            for s in revived + servers[2:]:
                s.stop()

    statuses, before, during, back, after, opens = _both(run)
    assert statuses == [200] * 48 and back
    assert before == after == ["w0", "w1", "w2"] and during == {"w2"} and opens == 2


@pytest.mark.parametrize("pkg", list(PKGS))
def test_request_coalescer_groups_same_path(pkg):
    co = PKGS[pkg][0]._RequestCoalescer(window_s=0.2, max_group=4)
    groups = []
    threads = [threading.Thread(target=lambda: groups.append(co.join("/score")))
               for _ in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(g) for g in groups}) == 1 and groups[0].count == 4
    assert time.perf_counter() - t0 < 0.19  # released on reaching max_group, not the window
    g2 = co.join("/score")
    assert g2 is not groups[0] and g2.count == 1


def test_coalesced_front_sends_a_group_to_one_worker():
    stubs = [Stub("a"), Stub("b")]

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([s.info(i) for i, s in enumerate(stubs)], timeout_s=10,
                                coalesce_window_ms=300.0, coalesce_max_group=4)
        try:
            out = [None] * 4
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(
                i, _call(front, "/score", json.dumps({"i": i}).encode()))) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            text = _get(front, "/metrics").decode()
            occupancy = [line for line in text.splitlines()
                         if line.startswith("synapseml_route_bucket_occupancy_count")]
            return len({b["worker"] for _, b, _ in out}), sorted(b["body"]["i"] for _, b, _ in out), \
                bool(occupancy)
        finally:
            front.close()

    try:
        assert _both(run) == (1, [0, 1, 2, 3], True)
    finally:
        for s in stubs:
            s.stop()


def test_front_metrics_get_gate_and_trace_stitching():
    live, held = Stub("live"), _Held()
    dead = held.port
    names = {**_names([live]), f"127.0.0.1:{dead}": "dead"}
    trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([live.info(1), {"host": "127.0.0.1", "port": dead, "pid": 2}],
                                timeout_s=5, resurrect_after_s=300)
        obs.get_tracer().clear()
        try:
            for _ in range(4):
                assert _call(front, "/p")[0] == 200
            _, echoed, _ = _call(front, "/metrics")  # a POST forwards
            _, traced, _ = _call(front, "/p", headers={
                "traceparent": f"00-{trace_id}-{parent}-01"})
            text = _get(front, "/metrics").decode()
            gauges = {names.get(line.split('endpoint="')[1].split('"')[0]): line.rsplit(" ", 1)[1]
                      for line in text.splitlines()
                      if line.startswith("synapseml_breaker_state{") and 'plane="front"' in line
                      and line.split('endpoint="')[1].split('"')[0] in names}
            spans = json.loads(_get(front, "/trace"))
            route = [s for s in spans if s["name"] == "route.request" and s["trace_id"] == trace_id]
            sent_tp = traced["tp"].split("-")
            return (echoed["worker"], echoed["path"], gauges,
                    all(k in text for k in ("synapseml_route_request_duration_ms_bucket",
                                            "synapseml_route_pick_ms",
                                            "synapseml_route_version_requests_total{")),
                    len(route), route[0]["parent_id"] if route else None,
                    sent_tp[1] == trace_id and sent_tp[2] == (route[0]["span_id"] if route else ""))
        finally:
            front.close()

    try:
        got = _both(run)
    finally:
        live.stop()
        held.free()
    assert got == ("live", "/metrics", {"dead": "2", "live": "0"}, True, 1, parent, True)


def test_canary_split_shadow_and_admin_split():
    stubs = [Stub("a", version="v1"), Stub("b", version="v2")]
    names = _names(stubs)

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([s.info(i) for i, s in enumerate(stubs)], timeout_s=5)
        try:
            front._split_rng.seed(1234)
            front.set_traffic_split({"v1": 3, "v2": 1})
            split = front.traffic_split()
            versions = [_call(front)[2]["X-Served-Version"] for _ in range(40)]
            _stats(front, names)  # the last reply's post-reply work done: it is not mirrored
            front.set_shadow("v2")
            mirrored = 0
            for i in range(10):  # each v1 reply's duplicate lands before the next
                mirrored += _call(front, body=json.dumps({"i": i}).encode())[2][
                    "X-Served-Version"] == "v1"
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and \
                        front.version_stats().get("v2", {}).get("shadow_ok", 0) < mirrored:
                    time.sleep(0.005)
            text = _get(front, "/metrics").decode()
            gauge = sorted(line.split('version="')[1].split('"')[0] for line in text.splitlines()
                           if line.startswith("synapseml_route_split_weight{"))
            got = _call(front, "/admin/split", json.dumps(
                {"split": None, "shadow": None}).encode())
            bad = _call(front, "/admin/split", b"[1]")
            req = urllib.request.Request(front.address + "/admin/split")
            with urllib.request.urlopen(req, timeout=10) as r:
                read = json.loads(r.read())
            stats = _stats(front, names)
            return split, versions, gauge, got[0], got[1], bad[0], read, stats
        finally:
            front.close()

    try:
        split, versions, gauge, status, reply, bad, read, stats = _both(run)
    finally:
        for s in stubs:
            s.stop()
    assert split == {"v1": 0.75, "v2": 0.25} and set(versions) == {"v1", "v2"}
    assert versions.count("v1") > versions.count("v2") and gauge == ["v1", "v2"]
    assert status == 200 and reply == {"ok": True, "split": None, "shadow": None} and bad == 400
    assert read == {"split": None, "shadow": None}
    assert stats["versions"]["v2"]["shadow_ok"] >= 1 and stats["versions"]["v2"]["shadow_err"] == 0


def test_admission_sheds_at_the_front_with_retry_after():
    stub = Stub("m0")

    def run(ds, res, obs, fleet):
        ctrl = fleet.AdmissionController(
            {"m": fleet.AdmissionPolicy(rate_rps=1.0, burst=4.0, interactive_reserve=0.5,
                                        retry_after_s=3.0)}, clock=lambda: 0.0)
        front = ds.RoutingFront([stub.info(1)], timeout_s=5, admission=ctrl)
        try:
            out = []
            for prio in ("bulk",) * 3 + ("interactive",) * 3:
                status, body, hdrs = _call(front, "/m/m/score",
                                           headers={"X-Priority": prio})
                out.append((prio, status, hdrs.get("Retry-After"),
                            body.get("reason") if status == 429 else body["path"]))
            out.append(_call(front, "/m/other")[0])  # no policy: unthrottled
            return out, _stats(front, _names([stub]))
        finally:
            front.close()

    try:
        out, stats = _both(run)
    finally:
        stub.stop()
    assert out[:6] == [("bulk", 200, None, "/m/m/score"), ("bulk", 200, None, "/m/m/score"),
                       ("bulk", 429, "1", "rate"), ("interactive", 200, None, "/m/m/score"),
                       ("interactive", 200, None, "/m/m/score"), ("interactive", 429, "1", "rate")]
    assert out[6] == 200
    assert stats["admission"]["m"]["admitted"] == {"interactive": 2, "bulk": 2}
    assert stats["versions"]["m"]["shed"] == {"interactive": 1, "bulk": 1}
    assert stats["versions"]["m"]["inflight"] == {"interactive": 0, "bulk": 0}


def test_prefix_routing_packs_shared_heads_on_one_worker():
    stubs = [Stub(f"w{i}") for i in range(3)]
    head = list(range(3, 19))
    bodies = [{"input_ids": head + [100 + i]} for i in range(6)] + \
        [{"prompt": "system: be brief. " * 20 + f"q{i}"} for i in range(6)] + \
        [{"input_ids": [i, i + 1, i + 2]} for i in range(6)] + [{"x": 1}, "text"]

    def run(ds, res, obs, fleet):
        sigs = [ds._prefix_sig(json.dumps(b).encode()) for b in bodies]
        front = ds.RoutingFront([s.info(i) for i, s in enumerate(stubs)], timeout_s=5,
                                route_by_prefix=True)
        try:
            served = [_call(front, body=json.dumps(b).encode())[1]["worker"] for b in bodies]
            return sigs, served
        finally:
            front.close()

    try:
        sigs, served = _both(run)
    finally:
        for s in stubs:
            s.stop()
    assert len(set(sigs[:6])) == 1 and len(set(sigs[6:12])) == 1 and sigs[18:] == [None, None]
    assert len(set(served[:6])) == 1 and len(set(served[6:12])) == 1


def test_retrieval_fanout_with_a_dead_holder():
    holders = [Stub("h0", shards=["s0", "s1"]), Stub("h1", shards=["s1", "s2"])]
    held = _Held()
    dead = {"host": "127.0.0.1", "port": held.port, "pid": 9, "model": "idx",
            "shards": ["s2", "s3"]}
    body = json.dumps({"queries": [[0.5, 1.0], [2.0, 1.5], [0.0, 0.1]], "k": 3}).encode()

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([h.info(i) for i, h in enumerate(holders)] + [dead],
                                timeout_s=5, resurrect_after_s=300)
        try:
            status, reply, hdrs = _call(front, "/retrieval/idx", body)
            again = _call(front, "/retrieval/idx", body)
            errors = [_call(front, p, b)[0] for p, b in (("/retrieval/idx", b"{}"),
                                                          ("/retrieval/idx", b"nope"),
                                                          ("/retrieval/none", body))]
            return (status, reply, hdrs.get("X-Retrieval-Partial"), again[1],
                    again[2].get("X-Retrieval-Partial"), errors)
        finally:
            front.close()

    partial0 = retrieval_metrics()["partial"].labels(index="idx").value
    try:
        status, reply, partial, again, partial2, errors = _both(run)
    finally:
        for h in holders:
            h.stop()
        held.free()
    assert status == 200 and partial == partial2 == "s3" and reply == again
    assert reply["shards"] == ["s0", "s1", "s2"] and reply["missing"] == ["s3"]
    assert all(len(row) == 3 for row in reply["matches"])
    assert errors == [400, 400, 503]
    assert retrieval_metrics()["partial"].labels(index="idx").value == partial0 + 2


def test_trusted_version_labels_bypass_the_client_label_cap():
    def run(ds, res, obs, fleet):
        registry = ds.WorkerRegistry()
        front = ds.RoutingFront(registry=registry)
        try:
            cap = ds.RoutingFront._MAX_TRACKED_LABELS
            for i in range(cap + 5):
                front._record_shed(f"scan-{i}", "bulk")
            front._record_version("canary-v2", ok=False, latency_ms=9.0)
            stats = front.version_stats()
            return cap, len(stats), stats["other"]["shed"], stats["canary-v2"]["err"]
        finally:
            front.close()
            registry.close()

    cap, n, other, err = _both(run)
    assert n == cap + 2 and other == {"interactive": 0, "bulk": 5} and err == 1


def test_draining_worker_is_rerouted_without_a_retry():
    stubs = [Stub("leaving"), Stub("staying")]
    stubs[0].status, stubs[0].payload = 503, DRAINING

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([s.info(i) for i, s in enumerate(stubs)], timeout_s=5)
        try:
            served = [_call(front)[1]["worker"] for _ in range(6)]
            stats = json.loads(_get(front, "/stats"))
            return served, stats["resilience"]["retry_count"], sorted(stats["breakers"].values())
        finally:
            front.close()

    try:
        assert _both(run) == (["staying"] * 6, 0, ["closed", "closed"])
    finally:
        for s in stubs:
            s.stop()


def test_request_logger_hook_sees_every_forwarded_exchange():
    stub = Stub("w", version="v7")

    class Logger:
        def __init__(self):
            self.calls = []

        def log(self, **kw):
            kw.pop("latency_ms")
            self.calls.append(kw)

    def run(ds, res, obs, fleet):
        front = ds.RoutingFront([stub.info(1)], timeout_s=5)
        logger = Logger()
        try:
            front.set_request_logger(logger)
            assert front.request_logger() is logger
            _call(front, "/score", b'{"q": 1}')
            _stats(front, {})  # the reply's post-reply logging done
            front.set_request_logger(None)
            _call(front, "/score", b'{"q": 2}')
            return [{**c, "reply": json.loads(c["reply"])["body"]} for c in logger.calls]
        finally:
            front.close()

    try:
        calls = _both(run)
    finally:
        stub.stop()
    assert calls == [{"method": "POST", "path": "/score", "body": b'{"q": 1}',
                      "reply": {"q": 1}, "status": 200, "version": "v7"}]
