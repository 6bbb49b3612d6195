"""synapseml_torch's deployment plane (registry/deploy.py) against the JAX
package's.

The canary controller of each package is fed the same sequences of
per-version stats through a stand-in front and must reach the same
verdicts at the same polls (tripping on the error rate, ignoring the
counters from before its start, tripping on a p95 regression) and apply
the same rollback (the split snapped to the stable version, the shadow
cleared, the alias pinned back). End to end on the port: two worker
processes behind ``serve_pipeline_distributed`` serve registry versions of
a tagging stage; a canary of v2 is hot-swapped in under traffic with no
failed request, the split routes to both versions and shadows, a fault on
the canary's worker trips the controller, which rolls the split and the
alias back. Then ``promote`` puts every worker on one version, a version
whose last stage raises on every request is refused at its warmup, and,
loaded without warmup rows, fails its canary's requests (and only those)
until the controller's rollback reloads the stable version on its worker.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from _torch_worker_stages import Boom, VersionTag
from synapseml_torch.core.faults import FaultSpec, inject_faults
from synapseml_torch.core.pipeline import PipelineModel
from synapseml_torch.io.distributed_serving import serve_pipeline_distributed
from synapseml_torch.registry import CanaryController, Deployment, ModelRegistry, admin_load
from synapseml_torch.registry import deploy as tdeploy
from synapseml_tpu.registry import deploy as jdeploy

TESTS = os.path.dirname(os.path.abspath(__file__))


class _FakeFront:
    def __init__(self):
        self.stats, self.split, self.shadow_cleared = {}, None, False

    def version_stats(self):
        return {v: dict(s) for v, s in self.stats.items()}

    def set_traffic_split(self, split):
        self.split = split

    def clear_shadow(self):
        self.shadow_cleared = True


class _FakeRegistry:
    def __init__(self):
        self.pins = []

    def pin(self, model, alias, ref):
        self.pins.append((model, alias, ref))


def _both(polls, **kw):
    """Each package's controller over the same stats sequence: the verdict
    of every poll, then (when one tripped) the rollback it applied."""
    out = []
    for deploy in (jdeploy, tdeploy):
        front, reg = _FakeFront(), _FakeRegistry()
        front.stats = polls[0]
        ctl = deploy.CanaryController(front, stable="v1", canary="v2", registry=reg,
                                      model="echo", **kw)
        verdicts = []
        for stats in polls[1:]:
            front.stats = stats
            verdicts.append(ctl.check_once())
        reason = next((v for v in verdicts if v), None)
        if reason is not None:
            ctl._trip(reason)
        out.append((verdicts, ctl.rolled_back, front.split, front.shadow_cleared, reg.pins))
    assert out[0] == out[1]
    return out[1]


def test_canary_controller_trips_on_error_rate():
    polls = [{}, {"v1": {"ok": 50, "err": 0}, "v2": {"ok": 5, "err": 0}},
             {"v1": {"ok": 50, "err": 0}, "v2": {"ok": 5, "err": 1}},
             {"v1": {"ok": 50, "err": 0}, "v2": {"ok": 5, "err": 6}}]
    verdicts, rolled, split, cleared, pins = _both(polls, error_rate_threshold=0.5, window=10,
                                                   min_samples=4)
    assert verdicts[:2] == [None, None] and "error rate" in verdicts[2] and "6/11" in verdicts[2]
    assert rolled and split == {"v1": 1.0} and cleared and pins == [("echo", "prod", "v1")]


def test_canary_controller_ignores_history_before_start():
    polls = [{"v2": {"ok": 0, "err": 50}}, {"v2": {"ok": 0, "err": 50}},
             {"v2": {"ok": 1, "err": 53}}]
    verdicts, rolled, *_ = _both(polls, error_rate_threshold=0.5, window=10, min_samples=2)
    assert verdicts[0] is None and "error rate" in verdicts[1] and rolled


def test_canary_controller_trips_on_p95_regression():
    polls = [{}, {"v1": {"ok": 100, "err": 0, "p95_ms": 2.0, "n_latencies": 100},
                  "v2": {"ok": 20, "err": 0, "p95_ms": 3.0, "n_latencies": 20}},
             {"v1": {"ok": 100, "err": 0, "p95_ms": 2.0, "n_latencies": 100},
              "v2": {"ok": 40, "err": 0, "p95_ms": 9.0, "n_latencies": 9}},
             {"v1": {"ok": 100, "err": 0, "p95_ms": 2.0, "n_latencies": 100},
              "v2": {"ok": 40, "err": 0, "p95_ms": 9.0, "n_latencies": 40}}]
    verdicts, rolled, *_ = _both(polls, error_rate_threshold=1.1, p95_regression_factor=2.0,
                                 min_latency_samples=10)
    assert verdicts[:2] == [None, None]  # 1.5x, then too few samples
    assert verdicts[2] == "canary v2 p95 9.0ms > 2x stable 2.0ms" and rolled


def test_rollout_summary_matches_jax():
    replies = [{"load_ms": 12.5, "warmup": {"mode": "jit", "io_ms": 1.25, "compile_ms": 3.0,
                                            "executables_traced": 2}},
               {"load_ms": 7.0, "warmup": {"mode": "aot", "aot_hits": 4,
                                           "fallback_reason": "other runtime"}}, {}]
    got = [d.Deployment._rollout_summary("v2", replies) for d in (jdeploy, tdeploy)]
    assert got[0] == got[1]
    assert got[1]["modes"] == {"jit": 2, "aot": 1} and got[1]["total_load_ms"] == 19.5


def _post(url, data):
    req = urllib.request.Request(url, data=json.dumps(data).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _version(w):
    with urllib.request.urlopen(f"http://{w['host']}:{w['port']}/admin/version",
                                timeout=10) as r:
        return json.loads(r.read())["version"]


@pytest.mark.chaos(timeout_s=120)
def test_e2e_canary_rollout_with_autorollback(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([TESTS, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reg = ModelRegistry(str(tmp_path / "reg"))
    for v in ("v1", "v2"):
        reg.publish("echo", VersionTag(tag=v), version=v)
    reg.publish("echo", PipelineModel(stages=[VersionTag(tag="v3"), Boom()]), version="v3")
    reg.pin("echo", "prod", "v2")  # an eager promote the rollback must undo

    handle = serve_pipeline_distributed(VersionTag(tag="v1"), num_workers=2,
                                        batch_interval_ms=0, version="v1")
    try:
        def call(i):
            return _post(handle.address, {"i": i})

        first = [call(i) for i in range(4)]
        assert [(s, b["v"]) for s, b in first] == [(200, "v1")] * 4
        assert len({b["pid"] for _, b in first}) == 2
        dep = Deployment(handle, reg, "echo", warmup=[{"i": -1}])
        handle.front._split_rng.seed(1234)
        results, stop = [], threading.Event()

        def pound():
            i = 0
            while not stop.is_set():
                results.append(call(i)[0])
                i += 1

        t = threading.Thread(target=pound)
        t.start()
        try:
            assert dep.canary("v2", weight=0.1, num_workers=1) is None
        finally:
            stop.set()
            t.join(timeout=30)
        assert results and all(s == 200 for s in results)  # no request dropped by the swap
        assert reg.alias_target("echo", "canary") == "v2"
        assert handle.front.traffic_split() == {"v1": 0.9, "v2": 0.1}
        assert dep.last_rollout["workers"] == 1 and dep.last_rollout["modes"] == {"jit": 1}
        replies = [call(i)[1]["v"] for i in range(80)]
        assert set(replies) == {"v1", "v2"} and replies.count("v1") > replies.count("v2")

        handle.front.set_shadow("v2")
        for i in range(20):
            call(i)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                not handle.front.version_stats()["v2"].get("shadow_ok"):
            time.sleep(0.05)
        handle.front.clear_shadow()
        assert handle.front.version_stats()["v2"]["shadow_ok"] >= 1
        with urllib.request.urlopen(handle.address + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "synapseml_route_version_requests_total{" in text
        assert 'version="v2"' in text and "synapseml_route_shadow_requests_total{" in text

        # the canary's worker refuses connections: every request still
        # succeeds on the stable fleet while the controller sees v2 fail
        controller = CanaryController(handle.front, stable="v1", canary="v2", registry=reg,
                                      model="echo", error_rate_threshold=0.5, window=4,
                                      min_samples=2, interval_s=0.05).start()
        (v2_worker,) = [w for w in handle.registry.workers() if w.get("version") == "v2"]
        key = f"{v2_worker['host']}:{v2_worker['port']}"
        try:
            with inject_faults([FaultSpec(kind="connection_error", match=key,
                                          planes=("distributed_serving",))]):
                deadline = time.monotonic() + 45
                i = 0
                while time.monotonic() < deadline and not controller.rolled_back:
                    assert call(i)[0] == 200
                    i += 1
        finally:
            controller.stop()
        assert controller.rolled_back and "error rate" in controller.reason
        assert reg.alias_target("echo", "prod") == "v1"
        assert handle.front.traffic_split() == {"v1": 1.0}
        assert call(0)[1]["v"] == "v1"

        # promote: every worker on v1, the split cleared, prod pinned
        assert dep.promote("v1") == "v1"
        assert sorted(_version(w) for w in handle.registry.workers()) == ["v1", "v1"]
        assert handle.front.traffic_split() is None

        # v3 fails every request: its warmup refuses the load, no split moves
        with pytest.raises(RuntimeError, match="409"):
            dep.canary("v3", weight=0.5)
        assert handle.front.traffic_split() is None
        endpoint = f"http://{v2_worker['host']}:{v2_worker['port']}"
        with pytest.raises(RuntimeError, match="fails every request"):
            admin_load(endpoint, reg.root, "echo", "v3", warmup=[{"i": -1}])

        # loaded without warmup rows it goes in, and its canary trips
        bare = Deployment(handle, reg, "echo")
        ctl = bare.canary("v3", weight=0.5, autorollback={
            "error_rate_threshold": 0.5, "window": 4, "min_samples": 2, "interval_s": 0.05})
        outcomes = []
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline and not ctl.rolled_back:
            status, body = call(len(outcomes))
            outcomes.append((status, body.get("v")))
        assert ctl.rolled_back and "error rate" in ctl.reason
        failed = [o for o in outcomes if o[0] != 200]
        assert failed and all(o == (500, None) for o in failed)
        assert all(o == (200, "v1") for o in outcomes if o[0] == 200)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                sorted(_version(w) for w in handle.registry.workers()) != ["v1", "v1"]:
            time.sleep(0.05)
        assert sorted(_version(w) for w in handle.registry.workers()) == ["v1", "v1"]
        assert reg.alias_target("echo", "prod") == "v1"
        assert all(call(i)[1]["v"] == "v1" for i in range(8))
    finally:
        handle.stop()
