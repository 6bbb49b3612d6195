"""Deployment plane: hot-swap rollout, canary splits, auto-rollback.

Counterpart of ``synapseml_tpu/registry/deploy.py``, the same host code. A
worker's ``/admin/load`` goes through the port's warmup-only AOT contract
(``registry/aot.py``): the warmup breakdown a load reports is ``mode``
``"jit"``, so ``Deployment.last_rollout`` counts no AOT hits.

Ties the registry (versioned artifacts, mutable aliases) to the serving
fleet (``io/serving.py`` workers with ``POST /admin/load``; the
``io/distributed_serving.RoutingFront`` with weighted splits and shadow
traffic). The flow a rollout follows::

    publish v2 ──> Deployment.canary("v2", weight=0.1)
                     │  POST /admin/load on N workers (side-by-side load,
                     │  warmup batch, atomic swap, re-register)
                     │  front.set_traffic_split({stable: 0.9, v2: 0.1})
                     ▼
                CanaryController (polls front.version_stats())
                     │  errors feed a core.resilience.CircuitBreaker;
                     │  p95 regression vs the stable version checked too
          breaker OPEN│                                 │healthy long enough
                     ▼                                 ▼
                rollback: split→stable, alias back,    promote(): load on
                reload stable on swapped workers       all workers, pin prod

The controller deliberately reuses :class:`~synapseml_torch.core.resilience.
CircuitBreaker` for the trip decision — the canary is "a worker pool behind
a breaker": a failure-rate window with a minimum sample count, so one
unlucky request cannot roll back a healthy canary, and a genuinely broken
version trips within ``window`` requests.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from ..core import observability as obs
from ..core.resilience import CircuitBreaker

__all__ = ["Deployment", "CanaryController", "admin_load"]

_DEPLOY_METRICS = obs.HandleCache(lambda reg: {
    "events": reg.counter(
        "synapseml_deploy_events_total",
        "deployment plane events (swap/canary/promote/rollback)",
        ("event",)),
})


def _post_json(url: str, payload: dict, timeout_s: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            detail = json.loads(body).get("error", body.decode(errors="replace"))
        except (json.JSONDecodeError, UnicodeDecodeError):
            detail = body.decode(errors="replace")
        raise RuntimeError(f"{url} returned {e.code}: {detail}") from e


def admin_load(endpoint: str, registry_root: str, model: str, ref: str,
               warmup: list | None = None, version: str | None = None,
               timeout_s: float = 120.0, warmup_buckets: list | None = None,
               use_aot: bool = True, use_autotune: bool = True,
               use_sharding: bool = True) -> dict:
    """Hot-swap one worker (``endpoint`` = ``http://host:port``) to a
    registry version via its ``POST /admin/load``. Returns the worker's
    reply (``{"ok": true, "version": ..., "previous": ..., "warmup":
    {<breakdown>}}``); raises with the worker's error detail when the load
    or warmup failed (the worker keeps serving its old pipeline in that
    case). ``use_aot=False`` / ``use_autotune=False`` force the JIT-warmup
    / saved-defaults path even when the artifact ships AOT executables or
    autotuned backend pins (the coldstart bench's A/B switches).
    ``use_sharding=False`` forces a replicated load even when the
    manifest carries a ``sharding`` section (the worker otherwise
    re-applies the rule table + mesh before warmup)."""
    payload: dict = {"registry": registry_root, "model": model, "ref": ref}
    if warmup:
        payload["warmup"] = list(warmup)
    if warmup_buckets:
        payload["warmup_buckets"] = [int(b) for b in warmup_buckets]
    if version:
        payload["version"] = version
    if not use_aot:
        payload["aot"] = False
    if not use_autotune:
        payload["autotune"] = False
    if not use_sharding:
        payload["sharding"] = False
    return _post_json(endpoint.rstrip("/") + "/admin/load", payload,
                      timeout_s)


class Deployment:
    """Rollout orchestration for one model on one serving fleet.

    ``serving`` is a ``DistributedServing`` handle (or any object with a
    ``front`` and a ``registry`` whose ``workers()`` lists registrations);
    ``registry`` is the :class:`~synapseml_torch.registry.ModelRegistry` the
    versions were published to. All state transitions emit
    ``synapseml_deploy_events_total`` and move aliases atomically."""

    def __init__(self, serving, registry, model: str,
                 warmup: list | None = None, alias: str = "prod",
                 timeout_s: float = 120.0, use_aot: bool = True,
                 use_sharding: bool = True):
        self.serving = serving
        self.registry = registry
        self.model = model
        self.alias = alias
        self.warmup = list(warmup or [])
        self.timeout_s = timeout_s
        self.use_aot = use_aot
        self.use_sharding = use_sharding
        # per-rollout aggregate of the workers' warmup breakdowns — the
        # operator's one-glance answer to "did this rollout ride AOT?"
        self.last_rollout: dict | None = None
        self._controller: CanaryController | None = None

    # -- fleet introspection ----------------------------------------------
    def workers(self) -> list[dict]:
        return self.serving.registry.workers()

    def workers_by_version(self) -> dict[str, list[dict]]:
        from ..io.distributed_serving import _version_of

        out: dict[str, list[dict]] = {}
        for w in self.workers():
            out.setdefault(_version_of(w), []).append(w)
        return out

    def stable_version(self) -> str:
        """The version serving the majority of the fleet (ties: the alias
        target, then the lexicographically first)."""
        by_version = self.workers_by_version()
        if not by_version:
            raise RuntimeError("no workers registered")
        pinned = self.registry.alias_target(self.model, self.alias)
        return sorted(by_version,
                      key=lambda v: (-len(by_version[v]), v != pinned, v))[0]

    def _endpoint(self, w: dict) -> str:
        return f"http://{w.get('host')}:{w.get('port')}"

    def _load_on(self, targets: list[dict], ref: str) -> list[dict]:
        replies = []
        for w in targets:
            replies.append(admin_load(
                self._endpoint(w), self.registry.root, self.model, ref,
                warmup=self.warmup, timeout_s=self.timeout_s,
                use_aot=self.use_aot, use_sharding=self.use_sharding))
        self.last_rollout = self._rollout_summary(ref, replies)
        return replies

    @staticmethod
    def _rollout_summary(ref: str, replies: list[dict]) -> dict:
        """Aggregate the workers' /admin/load warmup breakdowns: total
        swap wall, AOT hit/trace counts, and which workers fell back to
        JIT (a mixed fleet is the signal an operator needs to see)."""
        summary = {"ref": ref, "workers": len(replies),
                   "total_load_ms": 0.0, "io_ms": 0.0, "compile_ms": 0.0,
                   "aot_hits": 0, "executables_traced": 0,
                   "modes": {}, "fallback_reasons": []}
        for reply in replies:
            summary["total_load_ms"] += float(reply.get("load_ms", 0.0))
            wu = reply.get("warmup") or {}
            summary["io_ms"] += float(wu.get("io_ms", 0.0))
            summary["compile_ms"] += float(wu.get("compile_ms", 0.0))
            summary["aot_hits"] += int(wu.get("aot_hits", 0))
            summary["executables_traced"] += int(
                wu.get("executables_traced", 0))
            mode = wu.get("mode", "jit")
            summary["modes"][mode] = summary["modes"].get(mode, 0) + 1
            if wu.get("fallback_reason"):
                summary["fallback_reasons"].append(wu["fallback_reason"])
        for field in ("total_load_ms", "io_ms", "compile_ms"):
            summary[field] = round(summary[field], 2)
        return summary

    def _wait_registered(self, version: str, n: int,
                         timeout_s: float = 10.0) -> None:
        """Swapped workers re-register asynchronously; the split must not
        activate before the front can route to the new version."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.workers_by_version().get(version, ())) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"{n} worker(s) did not re-register as {version!r} within "
            f"{timeout_s}s")

    # -- rollout verbs -----------------------------------------------------
    def canary(self, ref: str, weight: float = 0.05,
               num_workers: int = 1, shadow: bool = False,
               autorollback: dict | None = None) -> "CanaryController | None":
        """Start a canary: hot-swap ``num_workers`` workers to ``ref``, pin
        the ``canary`` alias, and split traffic ``1-weight / weight``
        between the stable version and the canary. ``shadow=True``
        additionally mirrors stable traffic to the canary (read-only
        comparison). ``autorollback`` (dict of CanaryController kwargs, or
        ``{}`` for defaults) starts the watchdog and returns it."""
        stable = self.stable_version()
        version = self.registry.resolve_ref(self.model, ref)
        if version == stable:
            raise ValueError(f"canary {version!r} is already the stable "
                             "version")
        targets = [w for w in self.workers()
                   if w.get("version") != version][:max(num_workers, 1)]
        if not targets:
            raise RuntimeError("no workers available to canary onto")
        self._load_on(targets, version)
        self._wait_registered(version, len(targets))
        self.registry.pin(self.model, "canary", version)
        front = self.serving.front
        front.set_traffic_split({stable: 1.0 - weight, version: weight})
        if shadow:
            front.set_shadow(version)
        _DEPLOY_METRICS.get()["events"].inc(event="canary")
        if autorollback is not None:
            self._controller = CanaryController(
                front, stable=stable, canary=version, deployment=self,
                **autorollback)
            self._controller.start()
            return self._controller
        return None

    def promote(self, ref: str | None = None) -> str:
        """Roll the canary (or ``ref``) to the whole fleet: load it on every
        worker, clear the split/shadow, pin the ``prod`` alias."""
        version = self.registry.resolve_ref(
            self.model, ref if ref is not None else "canary")
        self.stop_controller()
        targets = [w for w in self.workers() if w.get("version") != version]
        if targets:
            self._load_on(targets, version)
            self._wait_registered(version, len(self.workers()))
        front = self.serving.front
        front.set_traffic_split(None)
        front.clear_shadow()
        self.registry.pin(self.model, self.alias, version)
        _DEPLOY_METRICS.get()["events"].inc(event="promote")
        return version

    def rollback(self, stable: str | None = None,
                 reload_workers: bool = True) -> str:
        """Flip everything back to the stable version: route 100% of
        traffic to it, pin the alias back, and (by default) reload it on
        the workers that had been swapped to the canary."""
        stable = stable or self.stable_version()
        front = self.serving.front
        front.set_traffic_split({stable: 1.0})
        front.clear_shadow()
        self.registry.pin(self.model, self.alias, stable)
        if reload_workers:
            strays = [w for w in self.workers()
                      if w.get("version") not in (stable, None)]
            for w in strays:
                try:
                    admin_load(self._endpoint(w), self.registry.root,
                               self.model, stable, warmup=self.warmup,
                               timeout_s=self.timeout_s,
                               use_aot=self.use_aot,
                               use_sharding=self.use_sharding)
                except (RuntimeError, OSError):
                    # an unreachable canary worker stays excluded by the
                    # split; the supervisor/breaker planes own its health
                    pass
        _DEPLOY_METRICS.get()["events"].inc(event="rollback")
        return stable

    def stop_controller(self) -> None:
        if self._controller is not None:
            self._controller.stop()
            self._controller = None


class CanaryController:
    """Auto-rollback watchdog for an active canary.

    Polls ``front.version_stats()`` every ``interval_s`` and feeds each new
    canary outcome into a :class:`CircuitBreaker` configured with a
    failure-rate window (``error_rate_threshold`` over the last ``window``
    outcomes, at least ``min_samples`` seen). The breaker OPENING — or the
    canary's p95 latency exceeding ``p95_regression_factor`` × the stable
    version's p95 with enough samples — triggers exactly one rollback:
    traffic snaps to the stable version, the alias flips back, and (when
    constructed by :meth:`Deployment.canary`) the swapped workers reload
    the stable version. ``rolled_back``/``reason`` record the verdict."""

    def __init__(self, front, stable: str, canary: str,
                 deployment: Deployment | None = None,
                 registry=None, model: str | None = None,
                 alias: str = "prod",
                 error_rate_threshold: float = 0.5, window: int = 20,
                 min_samples: int = 3, p95_regression_factor: float = 0.0,
                 min_latency_samples: int = 20,
                 interval_s: float = 0.25,
                 on_rollback=None):
        self.front = front
        self.stable = stable
        self.canary = canary
        self.deployment = deployment
        self.registry = registry if registry is not None else (
            deployment.registry if deployment is not None else None)
        self.model = model or (deployment.model
                               if deployment is not None else None)
        self.alias = alias
        self.p95_regression_factor = float(p95_regression_factor)
        self.min_latency_samples = int(min_latency_samples)
        self.interval_s = float(interval_s)
        self.on_rollback = on_rollback
        self.rolled_back = False
        self.reason: str | None = None
        self._breaker = CircuitBreaker(
            failure_rate_threshold=error_rate_threshold, window=window,
            min_samples=min_samples, name=f"canary {canary}")
        # baseline against the front's CUMULATIVE counters at construction:
        # a long-lived front carries history from earlier rollouts of the
        # same version, and replaying it into the fresh breaker would trip
        # a healthy re-canary before it serves a single new request
        baseline = self.front.version_stats().get(canary, {})
        self._seen = {"ok": baseline.get("ok", 0),
                      "err": baseline.get("err", 0)}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "CanaryController":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            reason = self.check_once()
            if reason is not None:
                self._trip(reason)
                return

    def check_once(self) -> str | None:
        """One poll: feed new outcomes, return a rollback reason or None.
        Public so tests (and callers without a thread) can drive it
        deterministically."""
        stats = self.front.version_stats()
        canary = stats.get(self.canary, {})
        ok, err = canary.get("ok", 0), canary.get("err", 0)
        for _ in range(max(ok - self._seen["ok"], 0)):
            self._breaker.record_success()
        for _ in range(max(err - self._seen["err"], 0)):
            self._breaker.record_failure()
        self._seen = {"ok": ok, "err": err}
        if self._breaker.state != CircuitBreaker.CLOSED:
            total = ok + err
            return (f"canary {self.canary} error rate tripped the breaker "
                    f"({err}/{total} failed)")
        if self.p95_regression_factor > 0:
            stable = stats.get(self.stable, {})
            c_p95, s_p95 = canary.get("p95_ms"), stable.get("p95_ms")
            if (c_p95 is not None and s_p95 is not None and s_p95 > 0
                    and canary.get("n_latencies", 0)
                    >= self.min_latency_samples
                    and c_p95 > self.p95_regression_factor * s_p95):
                return (f"canary {self.canary} p95 {c_p95:.1f}ms > "
                        f"{self.p95_regression_factor:g}x stable "
                        f"{s_p95:.1f}ms")
        return None

    def _trip(self, reason: str) -> None:
        self.reason = reason
        self.rolled_back = True
        if self.deployment is not None:
            self.deployment.rollback(stable=self.stable)
        else:
            self.front.set_traffic_split({self.stable: 1.0})
            self.front.clear_shadow()
            if self.registry is not None and self.model:
                self.registry.pin(self.model, self.alias, self.stable)
            _DEPLOY_METRICS.get()["events"].inc(event="rollback")
        if self.on_rollback is not None:
            try:
                self.on_rollback(reason)
            except Exception:  # noqa: BLE001 - observer must not undo the rollback
                pass
