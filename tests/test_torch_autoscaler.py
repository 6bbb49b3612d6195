"""synapseml_torch.fleet's autoscaler against synapseml_tpu.fleet's.

The policy: the scripts of ``tests/test_fleet.py:219-370`` (doubling up,
cooldowns, the clamp, a p95 breach alone, crash replacement in the same
pass, the underload streak and the newest-first drain, a failing spawn,
the prefix hit rate riding along, the reconcile span and gauges) run
through each package with the same fake launcher, clock and signals, each
script one case; the events of every ``reconcile_once()``, ``desired``,
``actual`` and the worker-seconds are held equal (handle ids by order of
first appearance: each package numbers its handles from its own counter).
``_default_signals`` reads the queue depth and prefix hit rate of real
``/admin/stats`` endpoints.

The ``ThreadWorkerLauncher`` cases of ``tests/test_fleet.py:390-944``
serve, in each package, the reference's MLP pipeline (``_aot_pipeline``;
the port's twin over the same ONNX bytes, ``_torch_worker_stages``) from
that package's registry: replies agree to 1e-5, and ``/stats``, sheds,
statuses and split-weight gauges are equal. Traffic is sequential where the
record is compared, the admission clock is frozen, and the chaos kill lands
on a count of replies with the autoscaler stepped by ``reconcile_once()``.

One ``SubprocessWorkerLauncher`` worker on the CPU registers, serves,
drains and exits 0; a worker whose stage names the card exits non-zero on
this host and never registers.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _aot_pipeline import build_pipeline, sample_rows
from _torch_worker_stages import mlp_pipeline
from synapseml_torch import fleet as tfleet
from synapseml_torch.core import faults as tfaults
from synapseml_torch.core import observability as tobs
from synapseml_torch.core import resilience as tres
from synapseml_torch.io import distributed_serving as tds
from synapseml_torch.registry import ModelRegistry
from synapseml_tpu import fleet as jfleet
from synapseml_tpu.core import faults as jfaults
from synapseml_tpu.core import observability as jobs
from synapseml_tpu.core import resilience as jres
from synapseml_tpu.io import distributed_serving as jds
from synapseml_tpu.registry import ModelRegistry as JModelRegistry

PKGS = {"jax": dict(fleet=jfleet, ds=jds, obs=jobs, res=jres, faults=jfaults),
        "torch": dict(fleet=tfleet, ds=tds, obs=tobs, res=tres, faults=tfaults)}


def _both(run):
    """``run(pkg)`` for the JAX package then the port; equal records."""
    got = [run(PKGS["jax"]), run(PKGS["torch"])]
    assert got[0] == got[1]
    return got[1]


# ---------------------------------------------------------------------------
# the policy: the reference's scripts through both packages
# ---------------------------------------------------------------------------

def _fake_launcher(fleet):
    class FakeLauncher(fleet.WorkerLauncher):
        def __init__(self):
            self.n = 0
            self.dead: set[int] = set()
            self.drained: list[int] = []

        def spawn(self, slo):
            self.n += 1
            return fleet.WorkerHandle(model=slo.model, token=self.n, pid=-self.n,
                                      host="127.0.0.1", port=self.n, spawned_at=self.n,
                                      state="ready")

        def alive(self, h):
            return h.token not in self.dead

        def drain(self, h, timeout_s=30.0):
            self.drained.append(h.token)
            self.dead.add(h.token)  # a fake drain completes instantly
            return True

        def kill(self, h):
            self.dead.add(h.token)

        def reap(self, h):
            pass

    return FakeLauncher()


class _Rec:
    """The record of one script: every pass's events (handle ids renumbered
    by first appearance), desired and actual after it."""

    def __init__(self):
        self.ids: dict = {}
        self.passes: list = []

    def step(self, asc, model):
        events = []
        for e in asc.reconcile_once():
            e = dict(e)
            if "handle" in e:
                e["handle"] = self.ids.setdefault(e["handle"], len(self.ids))
            events.append(e)
        self.passes.append((events, asc.desired(model), asc.actual(model)))
        return events


def _script_doubling(pkg, rec):
    fleet = pkg["fleet"]
    t, sig = [0.0], [fleet.FleetSignals()]
    slo = fleet.ModelSLO(model="m", min_workers=1, max_workers=8, target_queue_depth=4.0,
                         scale_down_after=2, up_cooldown_s=10.0, down_cooldown_s=5.0)
    launcher = _fake_launcher(fleet)
    asc = fleet.FleetAutoscaler(fleet.FleetSpec(models=[slo], reconcile_interval_s=1.0),
                                launcher, clock=lambda: t[0],
                                signals_fn=lambda s, live: sig[0])
    assert [e["event"] for e in rec.step(asc, "m")] == ["spawn"]
    t[0], sig[0] = 1.0, fleet.FleetSignals(queue_per_worker=10.0)
    assert {e["event"] for e in rec.step(asc, "m")} == {"up", "spawn"}
    for now in (2.0, 12.0, 23.0, 34.0):  # the cooldown, 4, 8, the clamp
        t[0] = now
        rec.step(asc, "m")
    assert [p[1] for p in rec.passes] == [1, 2, 2, 4, 8, 8]
    return asc, launcher, t, sig


def _policy_doubling_cooldown_clamp(pkg, rec):
    _script_doubling(pkg, rec)


def _policy_p95_breach_alone(pkg, rec):
    fleet = pkg["fleet"]
    slo = fleet.ModelSLO(model="p", min_workers=1, max_workers=4, p95_slo_ms=50.0,
                         up_cooldown_s=0.0)
    asc = fleet.FleetAutoscaler(fleet.FleetSpec(models=[slo]), _fake_launcher(fleet),
                                clock=lambda: 0.0,
                                signals_fn=lambda s, live: fleet.FleetSignals(
                                    queue_per_worker=0.0, p95_ms=80.0))
    rec.step(asc, "p")
    assert asc.desired("p") == 2


def _policy_replace_streak_and_drain(pkg, rec):
    fleet = pkg["fleet"]
    asc, launcher, t, sig = _script_doubling(pkg, rec)
    for h in asc.live_handles("m")[:2]:
        launcher.kill(h)
    t[0] = 35.0
    events = [e["event"] for e in rec.step(asc, "m")]
    assert events.count("lost") == 2 and events.count("spawn") == 2 and asc.actual("m") == 8
    t[0], sig[0] = 36.0, fleet.FleetSignals(queue_per_worker=0.0)
    assert "down" not in [e["event"] for e in rec.step(asc, "m")]
    t[0] = 37.0
    assert [e["event"] for e in rec.step(asc, "m")] == ["down", "drain"]
    assert launcher.drained == [launcher.n]  # the newest worker
    t[0] = 38.0
    assert "drained" in [e["event"] for e in rec.step(asc, "m")]
    rec.passes.append(("worker_seconds", asc.worker_seconds["m"]))
    assert asc.worker_seconds["m"] > 0.0


def _policy_spawn_failure(pkg, rec):
    fleet = pkg["fleet"]
    launcher = _fake_launcher(fleet)

    def refuse(slo):
        raise RuntimeError("no capacity")

    launcher.spawn = refuse
    asc = fleet.FleetAutoscaler(fleet.FleetSpec(models=[fleet.ModelSLO(model="m")]),
                                launcher, clock=lambda: 0.0,
                                signals_fn=lambda s, live: fleet.FleetSignals())
    for _ in range(2):  # the loop survives, and the next pass retries
        assert [e["event"] for e in rec.step(asc, "m")] == ["spawn_failed"]
    assert asc.actual("m") == 0


def _policy_prefix_hit_rate_rides_along(pkg, rec):
    fleet = pkg["fleet"]
    t = [0.0]
    slo = fleet.ModelSLO(model="m", min_workers=1, max_workers=4, target_queue_depth=4.0,
                         up_cooldown_s=0.0)
    asc = fleet.FleetAutoscaler(
        fleet.FleetSpec(models=[slo]), _fake_launcher(fleet), clock=lambda: t[0],
        signals_fn=lambda s, live: fleet.FleetSignals(queue_per_worker=10.0,
                                                      prefix_hit_rate=0.9))
    assert {e["event"] for e in rec.step(asc, "m")} == {"up", "spawn"}
    t[0] = 1.0
    rec.step(asc, "m")
    assert asc.desired("m") == 4


def _policy_span_and_gauges(pkg, rec):
    fleet, obs = pkg["fleet"], pkg["obs"]
    asc = fleet.FleetAutoscaler(
        fleet.FleetSpec(models=[fleet.ModelSLO(model="span-m", min_workers=1)]),
        _fake_launcher(fleet), clock=lambda: 0.0,
        signals_fn=lambda s, live: fleet.FleetSignals())
    rec.step(asc, "span-m")
    assert [s for s in obs.get_tracer().finished_spans() if s.name == "fleet.reconcile"]
    snap = obs.get_registry().snapshot()
    rec.passes.append(("gauges", snap.get('synapseml_fleet_desired_workers{model="span-m"}'),
                       snap.get('synapseml_fleet_actual_workers{model="span-m"}'),
                       snap.get('synapseml_fleet_scale_events_total{direction="spawn",'
                                'model="span-m"}', 0) >= 1.0))


@pytest.mark.parametrize("script", [
    _policy_doubling_cooldown_clamp, _policy_p95_breach_alone,
    _policy_replace_streak_and_drain, _policy_spawn_failure,
    _policy_prefix_hit_rate_rides_along, _policy_span_and_gauges],
    ids=lambda f: f.__name__[len("_policy_"):])
def test_policy_scripts_equal_the_jax_autoscaler(script):
    def run(pkg):
        rec = _Rec()
        script(pkg, rec)
        return rec.passes

    passes = _both(run)
    assert passes  # every script reconciles at least once


# ---------------------------------------------------------------------------
# _default_signals over real /admin/stats
# ---------------------------------------------------------------------------

class _Gate:
    """A stage that holds the serve loop until released: requests behind
    it queue, so ``/admin/stats`` reports a real queue depth."""

    def __init__(self, base):
        self.release = threading.Event()
        gate = self

        class Held(base):
            def _transform(self, df):
                gate.release.wait(30)

                def per_part(p):
                    out = dict(p)
                    reply = np.empty(len(p["id"]), dtype=object)
                    reply[:] = [{"ok": True}] * len(p["id"])
                    out["reply"] = reply
                    return out

                return df.map_partitions(per_part)

        self.stage = Held()


def test_default_signals_read_queue_depth_and_prefix_hit_rate_from_admin_stats():
    from synapseml_torch.core.pipeline import Transformer
    from synapseml_torch.io.serving import serve_pipeline

    gate = _Gate(Transformer)
    servers, clients = [], []
    try:
        for queued, rate in ((3, 0.8), (5, 0.4), (0, None)):
            srv = serve_pipeline(gate.stage, batch_interval_ms=0)
            if rate is not None:
                srv.llm_stats_fn = (lambda r: lambda: {"prefix_cache": {"hit_rate": r}})(rate)
            servers.append(srv)
            for _ in range(queued):  # one taken by the held loop, the rest queue
                th = threading.Thread(target=_post, args=(srv.address + "/", b"{}"),
                                      daemon=True)
                th.start()
                clients.append(th)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and [s._queue.qsize() for s in servers] != [2, 4, 0]:
            time.sleep(0.01)
        assert [s._queue.qsize() for s in servers] == [2, 4, 0]

        class Front:
            def version_stats(self):
                return {"m": {"p95_ms": 12.5}}

        def run(pkg):
            fleet = pkg["fleet"]
            handles = [fleet.WorkerHandle(model="m", token=i + 1, pid=-(i + 1),
                                          host=s.host, port=s.port, state="starting")
                       for i, s in enumerate(servers)]
            asc = fleet.FleetAutoscaler(fleet.FleetSpec(models=[fleet.ModelSLO(model="m")]),
                                        _fake_launcher(fleet), front=Front())
            sig = asc._default_signals(asc.spec.models[0], handles)
            return (sig.queue_per_worker, sig.p95_ms, sig.workers_polled, sig.prefix_hit_rate,
                    [h.state for h in handles])

        queue, p95, polled, rate, states = _both(run)
        assert queue == pytest.approx(2.0) and p95 == 12.5 and polled == 3
        assert rate == pytest.approx(0.6) and states == ["ready"] * 3
    finally:
        gate.release.set()
        for th in clients:
            th.join(timeout=30)
        for srv in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# ThreadWorkerLauncher fleets serving the MLP from each package's registry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's registry with ``mlp`` (seed 0) and m0..m3 (seeds
    10..13): the reference's pipeline, and the port's twin over the same
    ONNX bytes."""
    base = tmp_path_factory.mktemp("fleet_stores")
    jroot, root = str(base / "jax"), str(base / "torch")
    jreg, treg = JModelRegistry(jroot), ModelRegistry(root)
    for name, seed in [("mlp", 0)] + [(f"m{i}", 10 + i) for i in range(4)]:
        jpipe = build_pipeline(seed=seed)
        jreg.publish(name, jpipe, version="v1")
        treg.publish(name, mlp_pipeline(jpipe.get("stages")[1].get("model_payload")),
                     version="v1")
    return {"jax": jroot, "torch": root}


def _store(pkg, stores):
    return stores["jax" if pkg["fleet"] is jfleet else "torch"]


def _post(url, body, headers=None, timeout=30.0):
    """(status, parsed JSON, headers); HTTP errors become statuses."""
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _mk_fleet(pkg, store, spec, admission=None, front_timeout_s=30.0):
    ds, fleet = pkg["ds"], pkg["fleet"]
    pkg["res"].reset_resilience_measures("distributed_serving")
    wreg = ds.WorkerRegistry()
    launcher = fleet.ThreadWorkerLauncher(store, wreg)
    front = ds.RoutingFront(registry=wreg, admission=admission, timeout_s=front_timeout_s)
    asc = fleet.FleetAutoscaler(spec, launcher, front=front, worker_registry=wreg)
    return wreg, launcher, front, asc


def _teardown(wreg, front, asc):
    asc.stop()
    front.close()
    wreg.close()


def _probs(record):
    """Pull every reply's ``probs`` out of a record (compared to 1e-5),
    leaving the rest to compare exactly."""
    probs = []

    def walk(x):
        if isinstance(x, dict):
            if "probs" in x:
                probs.append(x["probs"])
                return {k: ("<probs>" if k == "probs" else walk(v)) for k, v in x.items()}
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return x

    return walk(record), probs


def _both_replies(run):
    """``_both`` with every reply's probabilities held to 1e-5."""
    got = [_probs(run(PKGS["jax"])), _probs(run(PKGS["torch"]))]
    assert got[0][0] == got[1][0]
    np.testing.assert_allclose(np.asarray(got[1][1], np.float64),
                               np.asarray(got[0][1], np.float64), atol=1e-5)
    return got[1][0]


def _wait_gone(wreg, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and wreg.workers():
        time.sleep(0.05)
    return wreg.workers()


def test_worker_admin_stats_and_graceful_drain_zero_drops(stores):
    body = json.dumps(sample_rows(1)[0]).encode()

    def run(pkg):
        spec = pkg["fleet"].FleetSpec(models=[pkg["fleet"].ModelSLO(model="mlp", ref="v1")])
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec)
        try:
            asc.reconcile_once()
            asc.wait_ready("mlp", 1, timeout_s=30)
            w = wreg.workers()[0]
            endpoint = f"http://{w['host']}:{w['port']}"
            with urllib.request.urlopen(endpoint + "/admin/stats", timeout=10) as r:
                stats = json.loads(r.read())
            first = _post(endpoint + "/", body)[:2]
            # concurrent fire, drain mid-stream: every accepted request gets a
            # real reply, later ones a terminal 503 or a refused connection
            outcomes, lock = [], threading.Lock()

            def client(n):
                for _ in range(n):
                    try:
                        status, payload, _ = _post(endpoint + "/", body)
                    except OSError as e:  # a refused or reset connect after the exit
                        reason = getattr(e, "reason", e)
                        assert "timed out" not in str(reason).lower()
                        status, payload = "refused", str(reason)
                    with lock:
                        outcomes.append((status, payload))

            threads = [threading.Thread(target=client, args=(10,)) for _ in range(4)]
            for th in threads:
                th.start()
            status, reply, _ = _post(endpoint + "/admin/drain", b"{}")
            for th in threads:
                th.join(timeout=60)
            assert len(outcomes) == 40
            for st, payload in outcomes:
                assert st in (200, 503, "refused"), (st, payload)
                if st == 503:
                    assert "drain" in json.dumps(payload)
                if st == 200:
                    assert payload == first[1]
            assert any(st in (503, "refused") for st, _ in outcomes)
            return {"stats": {k: stats[k] for k in ("version", "pipeline", "queue_depth",
                                                    "pending", "draining")},
                    "swap_mode": stats["swap"]["mode"], "first": first,
                    "drain": (status, reply["draining"]), "left": _wait_gone(wreg)}
        finally:
            _teardown(wreg, front, asc)

    rec = _both_replies(run)
    assert rec["stats"]["draining"] is False and rec["stats"]["queue_depth"] == 0
    assert rec["swap_mode"] == "jit" and rec["drain"] == (200, True) and rec["left"] == []


def test_drain_endpoint_robustness_and_label_cap(stores):
    def run(pkg):
        fleet, ds = pkg["fleet"], pkg["ds"]
        spec = fleet.FleetSpec(models=[fleet.ModelSLO(model="mlp", ref="v1")])
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec)
        try:
            asc.reconcile_once()
            asc.wait_ready("mlp", 1, timeout_s=30)
            w = wreg.workers()[0]
            endpoint = f"http://{w['host']}:{w['port']}"
            bad = _post(endpoint + "/admin/drain", b"[1]")[:2]
            drained = []
            server = launcher._handles[0].token
            server.on_drained = (lambda cb: lambda r: (drained.append(r), cb(r)))(
                server.on_drained)
            s1, r1, _ = _post(endpoint + "/admin/drain", b"{}")
            try:
                s2, r2, _ = _post(endpoint + "/admin/drain", b"{}")
                second = (s2, r2["already_draining"])
            except OSError:
                second = (200, True)  # the first drain already stopped the server
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not drained:
                time.sleep(0.05)
            time.sleep(0.3)
            for i in range(ds.RoutingFront._MAX_TRACKED_LABELS + 20):
                front._record_shed(f"scan-{i}", "bulk")
            stats = front.version_stats()
            return {"bad": bad, "first": (s1, r1["already_draining"]), "second": second,
                    "on_drained": len(drained), "labels": len(stats),
                    "other_bulk": stats["other"]["shed"]["bulk"]}
        finally:
            _teardown(wreg, front, asc)

    rec = _both(run)
    assert rec["bad"][0] == 400 and "JSON object" in rec["bad"][1]["error"]
    assert rec["first"] == (200, False) and rec["second"] == (200, True)
    assert rec["on_drained"] == 1 and rec["other_bulk"] >= 20


def test_elastic_scale_up_and_drain_down_over_http(stores):
    body = json.dumps(sample_rows(1)[0]).encode()

    def run(pkg):
        fleet = pkg["fleet"]
        sig = [fleet.FleetSignals(queue_per_worker=0.0)]
        spec = fleet.FleetSpec(models=[fleet.ModelSLO(
            model="mlp", ref="v1", min_workers=1, max_workers=3, target_queue_depth=2.0,
            scale_down_after=1, up_cooldown_s=0.0, down_cooldown_s=0.0)])
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec)
        asc._signals_fn = lambda slo, live: sig[0]
        try:
            events = [e["event"] for e in asc.reconcile_once()]
            asc.wait_ready("mlp", 1, timeout_s=30)
            sig[0] = fleet.FleetSignals(queue_per_worker=10.0)
            events += [e["event"] for e in asc.reconcile_once()]
            asc.wait_ready("mlp", 2, timeout_s=30)
            served = []
            for _ in range(16):
                status, reply, hdrs = _post(front.address + "/m/mlp", body)
                served.append((status, hdrs.get("X-Served-By"), reply))
            sig[0] = fleet.FleetSignals(queue_per_worker=0.0)
            events += [e["event"] for e in asc.reconcile_once()]
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and len(wreg.workers()) > 1:
                time.sleep(0.05)
            return {"events": events, "served": served, "left": len(wreg.workers()),
                    "desired": asc.desired("mlp")}
        finally:
            _teardown(wreg, front, asc)

    rec = _both_replies(run)
    assert len({pid for _, pid, _ in rec["served"]}) == 2  # both workers took traffic
    assert {s for s, _, _ in rec["served"]} == {200}
    assert rec["left"] == 1 and rec["desired"] == 1
    assert rec["events"] == ["spawn", "up", "spawn", "down", "drain"]


def test_model_routing_never_answers_with_the_wrong_model(stores):
    row = sample_rows(1, seed=3)[0]

    def run(pkg):
        fleet, path = pkg["fleet"], pkg["fleet"].model_path
        spec = fleet.FleetSpec(models=[fleet.ModelSLO(model="m0", ref="v1"),
                                       fleet.ModelSLO(model="m1", ref="v1")])
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec,
                                               front_timeout_s=5.0)
        try:
            asc.reconcile_once()
            asc.wait_ready("m0", 1, timeout_s=30)
            asc.wait_ready("m1", 1, timeout_s=30)
            out = [_post(front.address + path("m1"), json.dumps(row).encode())[:2]]
            victim = asc.live_handles("m1")[0]
            launcher.kill(victim)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    _post(victim.endpoint + "/", json.dumps(row).encode(), timeout=2)
                except OSError:
                    break
                time.sleep(0.05)
            time.sleep(0.3)  # the stopped loop's last poll
            out += [_post(front.address + path("m1"), json.dumps(row).encode())[0]
                    for _ in range(4)]
            out.append(_post(front.address + path("m0"), json.dumps(row).encode())[:2])
            out.append(out[0][1]["probs"] != out[5][1]["probs"])  # m0 and m1 differ
            return out
        finally:
            _teardown(wreg, front, asc)

    rec = _both_replies(run)
    assert rec[0][0] == 200 and rec[1:5] == [503] * 4 and rec[5][0] == 200 and rec[6]


def test_admission_sheds_on_the_wire_with_a_frozen_clock(stores):
    body = json.dumps(sample_rows(1)[0]).encode()

    def run(pkg):
        fleet = pkg["fleet"]
        policy = fleet.AdmissionPolicy(rate_rps=40.0, burst=16.0, interactive_reserve=0.25,
                                       p99_budget_ms=60000.0, retry_after_s=0.5)
        spec = fleet.FleetSpec(models=[fleet.ModelSLO(model="mlp", ref="v1",
                                                      admission=policy)])
        ctrl = fleet.AdmissionController.from_spec(spec, clock=lambda: 0.0)
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec,
                                               admission=ctrl)
        try:
            asc.reconcile_once()
            asc.wait_ready("mlp", 1, timeout_s=30)
            url = front.address + fleet.model_path("mlp")
            seen = []
            for i in range(30):  # bulk spends down to the reserve, then interactive
                hdrs = {"X-Priority": "bulk"} if i % 3 else {}
                status, reply, got = _post(url, body, hdrs)
                seen.append((status, got.get("Retry-After"), reply))
            with urllib.request.urlopen(front.address + "/stats", timeout=10) as r:
                wire = json.loads(r.read())["admission"]
            stats = ctrl.stats()["mlp"]
            vstats = front.version_stats()["mlp"]
            return {"seen": seen, "admitted": stats["admitted"], "shed": stats["shed"],
                    "front_shed": vstats["shed"], "inflight": vstats["inflight"],
                    "wire_shed": wire["mlp"]["shed"]}
        finally:
            _teardown(wreg, front, asc)

    rec = _both_replies(run)
    statuses = [s for s, _, _ in rec["seen"]]
    assert set(statuses) == {200, 429} and statuses[:12].count(200) == 12
    assert all(int(ra) >= 1 for s, ra, _ in rec["seen"] if s == 429)
    assert rec["shed"]["bulk"] == rec["front_shed"]["bulk"] == rec["wire_shed"]["bulk"] > 0
    assert rec["admitted"]["bulk"] + rec["admitted"]["interactive"] == statuses.count(200)
    assert rec["inflight"] == {"interactive": 0, "bulk": 0}


def test_split_weights_exported_as_gauges():
    def run(pkg):
        ds, obs = pkg["ds"], pkg["obs"]
        wreg = ds.WorkerRegistry()

        def split_lines():
            return {ln for ln in obs.get_registry().exposition().splitlines()
                    if ln.startswith("synapseml_route_split_weight{")}

        before = split_lines()
        front = ds.RoutingFront(registry=wreg)
        try:
            front.set_traffic_split({"va": 0.75, "vb": 0.25})
            weights = {}
            for ln in split_lines() - before:
                for v in ("va", "vb"):
                    if f'version="{v}"' in ln:
                        weights[v] = float(ln.rsplit(" ", 1)[1])
            front.set_traffic_split(None)
            return weights, sorted(split_lines() - before)
        finally:
            front.close()
            wreg.close()

    assert _both(run) == ({"va": 0.75, "vb": 0.25}, [])


@pytest.mark.chaos(timeout_s=120)
def test_chaos_worker_killed_on_a_reply_count_is_replaced_in_one_pass(stores):
    body = json.dumps(sample_rows(1)[0]).encode()

    def run(pkg):
        fleet, faults = pkg["fleet"], pkg["faults"]
        spec = fleet.FleetSpec(models=[fleet.ModelSLO(model="mlp", ref="v1", min_workers=2,
                                                      max_workers=2)],
                               reconcile_interval_s=0.25)
        wreg, launcher, front, asc = _mk_fleet(pkg, _store(pkg, stores), spec,
                                               front_timeout_s=5.0)
        try:
            events = [e["event"] for e in asc.reconcile_once()]
            asc.wait_ready("mlp", 2, timeout_s=30)
            victim = asc.live_handles("mlp")[0]
            outcomes, by_victim = [], 0
            with faults.inject_faults([faults.FaultSpec("connection_error", times=3,
                                                        planes=("distributed_serving",))]):
                for i in range(60):
                    try:
                        status, reply, hdrs = _post(front.address + "/m/mlp", body,
                                                    timeout=20)
                    except OSError as e:  # a transport failure would be a drop
                        status, reply, hdrs = f"transport:{e}", None, {}
                    outcomes.append((status, reply))
                    if hdrs.get("X-Served-By") == str(victim.pid):
                        by_victim += 1
                        if by_victim == 8:
                            launcher.kill(victim)  # the socket slams shut
                            events += [e["event"] for e in asc.reconcile_once()]
            live = asc.live_handles("mlp")
            # every request got a terminal HTTP outcome, nothing hung or was
            # dropped; which of them met the dying worker is timing, so the
            # record holds the pass events and one reply
            statuses = [st for st, _ in outcomes]
            assert all(isinstance(st, int) for st in statuses), statuses
            assert statuses.count(200) > len(statuses) * 0.8
            return {"events": events, "replies": [r for st, r in outcomes if st == 200][:1],
                    "replaced": len(live) == 2 and victim not in live}
        finally:
            _teardown(wreg, front, asc)

    rec = _both_replies(run)
    assert rec["events"] == ["spawn", "spawn", "lost", "spawn"]  # replaced in that pass
    assert rec["replaced"]


# ---------------------------------------------------------------------------
# one fresh-interpreter worker on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.chaos(timeout_s=180)
def test_subprocess_worker_registers_serves_drains_and_a_card_stage_never_registers(
        stores, tmp_path):
    from _torch_worker_stages import mlp_pipeline as twin

    root = stores["torch"]
    jpipe = build_pipeline(seed=0)
    ModelRegistry(root).publish("mlp_card", twin(jpipe.get("stages")[1].get("model_payload"),
                                                 device="cuda"), version="v1")
    wreg = tds.WorkerRegistry()
    launcher = tfleet.SubprocessWorkerLauncher(root, wreg, use_aot=True,
                                               warmup_rows=sample_rows(2))
    front = tds.RoutingFront(registry=wreg)
    try:
        card = launcher.spawn(tfleet.ModelSLO(model="mlp_card", ref="v1"))
        handle = launcher.spawn(tfleet.ModelSLO(model="mlp", ref="v1"))
        wreg.wait_for(1, timeout_s=120)
        rows = sample_rows(3, seed=5)
        want = _probs([mlp_pipeline_reply(jpipe, r) for r in rows])
        got = [_post(front.address + "/m/mlp", json.dumps(r).encode())[:2] for r in rows]
        assert [s for s, _ in got] == [200] * 3
        got = _probs([r for _, r in got])
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=1e-5)
        worker = wreg.workers()[0]
        assert worker["pid"] == handle.pid and worker["model"] == "mlp"
        assert worker["aot"] == "jit"  # no recorded executables: the JIT warmup route
        assert card.token.wait(timeout=60) != 0  # exits without registering
        handle.host, handle.port = worker["host"], worker["port"]
        assert launcher.drain(handle)
        assert handle.token.wait(timeout=60) == 0
        assert _wait_gone(wreg) == []
        assert card.pid not in {w["pid"] for w in wreg.workers()}
    finally:
        launcher.close()
        front.close()
        wreg.close()


def mlp_pipeline_reply(jpipe, row):
    """The JAX pipeline's reply to one request body, through the serve
    loop's batch preparation."""
    from synapseml_tpu.core.dataframe import DataFrame
    from synapseml_tpu.io.serving import _prepare_batch

    batch = DataFrame([{
        "id": np.asarray(["x"], dtype=object), "method": np.asarray(["POST"], dtype=object),
        "path": np.asarray(["/"], dtype=object),
        "body": np.asarray([json.dumps(row).encode()], dtype=object)}])
    out = jpipe.transform(_prepare_batch(batch, parse_json=True, input_col="body"))
    return out.collect_column("reply")[0]

