"""Elastic autoscaling: a reconcile loop spawning/draining serving workers
against per-model SLO targets.

Counterpart of ``synapseml_tpu/fleet/autoscaler.py``. The serving planes
already emit every signal a control loop needs: worker queue depth
(``GET /admin/stats``), routed p95 per model
(``RoutingFront.version_stats()``), shed rates (the admission controller).
:class:`FleetAutoscaler` closes the loop — each reconcile it reaps dead
workers, reads the signals, moves the per-model desired count (up fast on
queue/p95 pressure, down slowly after a sustained idle streak), and
converges the live set through a pluggable :class:`WorkerLauncher`:

* scale-UP workers ``/admin/load`` their registry ref; the port records no
  executables (``registry/aot.py``), so a load warms up by JIT and
  scale-up latency is process start + the artifact's I/O + the warmup;
* scale-DOWN workers drain gracefully (``POST /admin/drain``): they stop
  accepting requests, finish the queued backlog with terminal replies,
  deregister from the :class:`~synapseml_torch.io.distributed_serving.
  WorkerRegistry`, and exit — indistinguishable-from-crash removals are
  gone;
* a worker lost to a real crash is replaced within one reconcile interval
  (the chaos acceptance), with the front's per-worker breakers containing
  the blast radius in the meantime.

Two launchers ship: :class:`ThreadWorkerLauncher` (in-process servers on
real ports — cheap, for tests and single-host fleets; they share the
process's CUDA context) and :class:`SubprocessWorkerLauncher` (one OS
process per worker via :func:`fleet_worker_main`). A subprocess worker is a
fresh interpreter (``subprocess.Popen``, never a fork of a parent that may
hold a CUDA context) on a ``PYTHONPATH`` of the import roots of the
artifact's stage classes; it serves on its stages' ``device`` and resolves
that device before it registers, so a stage that names the card exits the
worker non-zero on a host without one, never serving on the CPU. Both
launchers register workers over the registry's real HTTP surface so the
front routes to a scaled-up worker the moment it is ready.

Decisions and state export as ``synapseml_fleet_*`` series (desired/actual
workers, scale events, worker-seconds) and every reconcile runs under one
``fleet.reconcile`` span.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from ..core import observability as obs
from ..core.pipeline import Transformer
from .spec import FleetSpec, ModelSLO

__all__ = ["WorkerHandle", "WorkerLauncher", "ThreadWorkerLauncher",
           "SubprocessWorkerLauncher", "FleetAutoscaler", "FleetSignals",
           "fleet_worker_main"]

_FLEET_METRICS = obs.HandleCache(lambda reg: {
    "desired": reg.gauge(
        "synapseml_fleet_desired_workers",
        "autoscaler desired worker count", ("model",)),
    "actual": reg.gauge(
        "synapseml_fleet_actual_workers",
        "live (spawned, not drained) worker count", ("model",)),
    "scale_events": reg.counter(
        "synapseml_fleet_scale_events_total",
        "autoscaler scale decisions", ("model", "direction")),
    "worker_seconds": reg.counter(
        "synapseml_fleet_worker_seconds_total",
        "accumulated live worker-seconds (the fleet's cost integral)",
        ("model",)),
    "reconcile_ms": reg.histogram(
        "synapseml_fleet_reconcile_ms",
        "wall time of one reconcile pass").labels(),
})

_HANDLE_IDS = itertools.count(1)


def _post_json(url: str, payload: dict, timeout_s: float = 10.0) -> None:
    """The one JSON-POST helper every fleet HTTP hop uses (registration,
    drain) — the header/encoding/timeout contract lives in one place."""
    urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"}),
        timeout=timeout_s).read()


class _PlaceholderStage(Transformer):
    """What a spawning worker serves for the instant before its
    ``/admin/load`` swap lands: every request gets a terminal 503-ish
    reply, never a hang."""

    def _transform(self, df):
        def per_part(p):
            out = dict(p)
            out["reply"] = np.asarray(
                [{"error": "worker still loading"}] * len(p["id"]),
                dtype=object)
            return out

        return df.map_partitions(per_part)


@dataclasses.dataclass
class WorkerHandle:
    """One launched worker as the autoscaler tracks it. ``token`` is
    launcher-private (the server object / the Popen)."""

    model: str
    token: object = None
    pid: int | None = None
    host: str | None = None
    port: int | None = None
    spawned_at: float = 0.0
    state: str = "starting"  # starting -> ready -> draining -> dead
    drain_at: float | None = None
    handle_id: int = dataclasses.field(
        default_factory=lambda: next(_HANDLE_IDS))

    @property
    def endpoint(self) -> str | None:
        if self.host is None or self.port is None:
            return None
        return f"http://{self.host}:{self.port}"


class WorkerLauncher:
    """The pluggable spawn/drain/kill surface the autoscaler drives.
    Implementations must make ``spawn`` non-blocking-ish (a worker may
    finish coming up after spawn returns; it counts as live meanwhile)."""

    def spawn(self, slo: ModelSLO) -> WorkerHandle:
        raise NotImplementedError

    def alive(self, handle: WorkerHandle) -> bool:
        raise NotImplementedError

    def drain(self, handle: WorkerHandle, timeout_s: float = 30.0) -> bool:
        """Ask the worker to drain gracefully; False when unreachable (the
        caller falls back to :meth:`kill`). The POST replies immediately
        (the backlog finishes asynchronously), so the HTTP timeout is kept
        SHORT — the autoscaler calls this under its lock, and a wedged
        victim must not stall introspection for long."""
        endpoint = handle.endpoint
        if endpoint is None:
            return False
        try:
            _post_json(endpoint + "/admin/drain",
                       {"timeout_s": timeout_s}, timeout_s=3.0)
            return True
        except (urllib.error.URLError, OSError):
            return False

    def kill(self, handle: WorkerHandle) -> None:
        raise NotImplementedError

    def reap(self, handle: WorkerHandle) -> None:
        """Post-death cleanup (process wait / socket close). Idempotent."""

    def close(self) -> None:
        """Tear down everything this launcher spawned."""


class ThreadWorkerLauncher(WorkerLauncher):
    """In-process workers: each ``spawn`` starts a real
    ``serve_pipeline`` HTTP server on its own port (own serve thread, grad
    off, the process's CUDA context), ``/admin/load``s the model's registry
    ref, resolves its stages' devices, and registers with the front's
    :class:`~synapseml_torch.io.distributed_serving.WorkerRegistry` over
    HTTP — the full fleet surface without process-spawn cost. ``kill``
    closes the server socket abruptly (the crash the chaos tests inject);
    drained workers deregister and stop cleanly."""

    def __init__(self, registry_root: str, worker_registry,
                 use_aot: bool = False, warmup_rows: list | None = None,
                 serve_defaults: dict | None = None):
        self.registry_root = str(registry_root)
        self.worker_registry = worker_registry
        self.use_aot = bool(use_aot)
        self.warmup_rows = list(warmup_rows or [])
        self.serve_defaults = dict(serve_defaults or {})
        self._pids = itertools.count(-2, -1)  # fake, unique, never a real pid
        self._handles: list[WorkerHandle] = []

    def spawn(self, slo: ModelSLO) -> WorkerHandle:
        from ..io.serving import serve_pipeline

        kwargs = {"batch_interval_ms": 5, **self.serve_defaults,
                  **dict(slo.serve)}
        server = serve_pipeline(_PlaceholderStage(), version="starting",
                                **kwargs)
        payload = {"registry": self.registry_root, "model": slo.model,
                   "ref": slo.ref, "version": slo.model,
                   "aot": self.use_aot}
        if self.warmup_rows:
            payload["warmup"] = self.warmup_rows
        status, reply = server._admin_load(json.dumps(payload).encode())
        if status != 200:
            server.stop()
            raise RuntimeError(f"worker load of {slo.model}:{slo.ref} "
                               f"failed: {reply}")
        from ..io.distributed_serving import _check_devices

        try:
            _check_devices(server.pipeline_holder.pipeline)
        except Exception:
            server.stop()
            raise
        handle = WorkerHandle(model=slo.model, token=server,
                              pid=next(self._pids), host=server.host,
                              port=server.port,
                              spawned_at=time.monotonic(), state="ready")
        info = {"host": server.host, "port": server.port,
                "pid": handle.pid, "version": slo.model,
                "model": slo.model,
                "aot": (reply.get("warmup") or {}).get("mode")}
        register_url = self.worker_registry.address + "/register"

        def on_drained(_report):
            from ..io.distributed_serving import deregister_worker

            handle.state = "dead"
            deregister_worker(register_url, info)
            server.stop()

        server.on_drained = on_drained
        try:
            _post_json(register_url, info)
        except (urllib.error.URLError, OSError):
            # a failed registration must not leak a running, loaded server
            # the autoscaler can never reach (it would be in neither the
            # handle set nor the registry)
            server.stop()
            raise
        self._handles.append(handle)
        return handle

    def alive(self, handle: WorkerHandle) -> bool:
        server = handle.token
        return handle.state != "dead" and getattr(server, "_running", False)

    def kill(self, handle: WorkerHandle) -> None:
        """Abrupt crash: close the listening socket mid-flight, leaving the
        (now stale) registration for the breakers to discover."""
        handle.state = "dead"
        server = handle.token
        try:
            server.stop()
        except OSError:
            pass

    def reap(self, handle: WorkerHandle) -> None:
        if handle in self._handles:
            self._handles.remove(handle)

    def close(self) -> None:
        for handle in list(self._handles):
            self.kill(handle)
            self.reap(handle)


class SubprocessWorkerLauncher(WorkerLauncher):
    """One OS process per worker (:func:`fleet_worker_main`): the honest
    scale-up measurement — a spawned worker pays interpreter + torch init +
    registry resolve + its CUDA context and warmup. The worker is a fresh
    interpreter (``subprocess.Popen``), never a fork of this process, which
    may hold a CUDA context. Its ``PYTHONPATH`` holds the repository root,
    the import root of each stage class the artifact's manifest names (the
    directory its dotted module name resolves from, never the module's own
    directory, whose files could shadow the standard library's), and
    ``extra_sys_path``. The worker registers itself; the autoscaler
    backfills host/port from the registry table when the registration
    lands."""

    def __init__(self, registry_root: str, worker_registry,
                 use_aot: bool = True, warmup_rows: list | None = None,
                 serve_defaults: dict | None = None,
                 env: dict | None = None,
                 extra_sys_path: tuple = ()):
        self.registry_root = str(registry_root)
        self.worker_registry = worker_registry
        self.use_aot = bool(use_aot)
        self.warmup_rows = list(warmup_rows or [])
        self.serve_defaults = dict(serve_defaults or {})
        self._env = dict(env or {})
        self._extra_sys_path = tuple(extra_sys_path)
        self._procs: list[subprocess.Popen] = []

    def _stage_roots(self, slo: ModelSLO) -> list[str]:
        """Import roots of the stage classes the model's manifest lists
        (those whose modules this process has imported)."""
        from ..io.distributed_serving import _import_root
        from ..registry.registry import ModelRegistry

        try:
            classes = ModelRegistry(self.registry_root).manifest(
                slo.model, slo.ref).get("stages") or []
        except (OSError, ValueError, KeyError):
            return []  # the worker's own resolve reports it
        roots = []
        for qual in classes:
            root = _import_root(str(qual).rpartition(".")[0])
            if root is not None and root not in roots:
                roots.append(root)
        return roots

    def spawn(self, slo: ModelSLO) -> WorkerHandle:
        register_url = self.worker_registry.address + "/register"
        kwargs = {"batch_interval_ms": 5, **self.serve_defaults,
                  **dict(slo.serve)}
        code = (
            "from synapseml_torch.fleet.autoscaler import fleet_worker_main; "
            f"fleet_worker_main({self.registry_root!r}, {slo.model!r}, "
            f"{slo.ref!r}, {register_url!r}, serve_kwargs={kwargs!r}, "
            f"use_aot={self.use_aot!r}, warmup_rows={self.warmup_rows!r})")
        env = dict(os.environ)
        env.update(self._env)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        paths = [repo_root]
        for root in (*self._stage_roots(slo), *self._extra_sys_path):
            if root not in paths:
                paths.append(root)
        env["PYTHONPATH"] = os.pathsep.join(
            [*paths, env.get("PYTHONPATH", "")])
        proc = subprocess.Popen([sys.executable, "-c", code], env=env)
        self._procs.append(proc)
        return WorkerHandle(model=slo.model, token=proc, pid=proc.pid,
                            spawned_at=time.monotonic())

    def alive(self, handle: WorkerHandle) -> bool:
        return handle.token.poll() is None

    def kill(self, handle: WorkerHandle) -> None:
        handle.state = "dead"
        handle.token.kill()

    def reap(self, handle: WorkerHandle) -> None:
        proc = handle.token
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc in self._procs:
            self._procs.remove(proc)

    def close(self) -> None:
        for proc in list(self._procs):
            proc.terminate()
        for proc in list(self._procs):
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._procs.clear()


def fleet_worker_main(registry_root: str, model: str, ref: str = "latest",
                      register_url: str | None = None,
                      serve_kwargs: dict | None = None,
                      use_aot: bool = True,
                      warmup_rows: list | None = None,
                      version: str | None = None) -> None:
    """Fleet worker process entry: serve a placeholder, ``/admin/load`` the
    registry ref (``use_aot=True`` logs one ``aot_fallback`` warning and
    warms up by JIT: this runtime records no executables), resolve every
    stage's ``device`` (a stage that names the card exits the worker
    non-zero on a host without one, before it registers), register with the
    worker registry, and park. ``POST /admin/drain`` finishes the backlog,
    deregisters, and exits the process — the graceful half of elasticity."""
    from ..io.distributed_serving import _check_devices
    from ..io.serving import serve_pipeline

    server = serve_pipeline(_PlaceholderStage(), version="starting",
                            **(serve_kwargs or {}))
    payload = {"registry": registry_root, "model": model, "ref": ref,
               "version": version or model, "aot": bool(use_aot)}
    if warmup_rows:
        payload["warmup"] = list(warmup_rows)
    status, reply = server._admin_load(json.dumps(payload).encode())
    if status != 200:
        print(f"fleet worker load failed ({status}): {reply}", flush=True)
        raise SystemExit(1)
    _check_devices(server.pipeline_holder.pipeline)
    info = {"host": server.host, "port": server.port, "pid": os.getpid(),
            "version": version or model, "model": model,
            "aot": (reply.get("warmup") or {}).get("mode")}
    if register_url:
        def on_drained(_report):
            from ..io.distributed_serving import deregister_worker

            deregister_worker(register_url, info)
            # sys.exit would only end the drain thread; the park loop below
            # holds the process — a drained worker must actually go away
            os._exit(0)

        server.on_drained = on_drained
        _post_json(register_url, info, timeout_s=30.0)
    print(f"fleet worker ready {info}", flush=True)
    while True:  # killed by the launcher, or exits via on_drained
        time.sleep(1.0)


@dataclasses.dataclass
class FleetSignals:
    """One model's observed load, as one reconcile pass read it."""

    queue_per_worker: float | None = None  # mean /admin/stats queue depth
    p95_ms: float | None = None            # routed p95 (version_stats)
    workers_polled: int = 0
    # mean engine prefix-cache hit rate across polled workers (LLM fleets
    # with ``prefix_cache`` on; None elsewhere) — the
    # ``synapseml_llm_prefix_hit_rate`` series as /admin/stats exposes it.
    # Observability for now: a high hit rate means routed stickiness is
    # working and effective per-worker capacity is above the cold number.
    prefix_hit_rate: float | None = None


class _ModelState:
    __slots__ = ("desired", "underload_streak", "last_up_at", "last_down_at")

    def __init__(self, desired: int):
        self.desired = desired
        self.underload_streak = 0
        self.last_up_at = float("-inf")
        self.last_down_at = float("-inf")


class FleetAutoscaler:
    """The reconcile loop over a :class:`~synapseml_torch.fleet.spec.
    FleetSpec`: every ``spec.reconcile_interval_s`` it reaps the dead,
    reads the signals, adjusts per-model desired counts, and converges the
    fleet through the launcher. ``front`` (a ``RoutingFront``) supplies
    routed p95 per model; ``worker_registry`` is the front's
    registration table dead workers are pruned from. ``signals_fn`` is
    injectable for deterministic tests (``(slo, live_handles) ->
    FleetSignals``); the default polls each worker's ``/admin/stats``.

    Scale policy (per model, all knobs on the :class:`ModelSLO`):

    * **up** — overloaded (queue/worker > ``target_queue_depth`` OR p95 >
      ``p95_slo_ms``) and past ``up_cooldown_s`` since the last up: desired
      doubles (clamped to ``max_workers``) — load steps are exponential,
      so the response is too;
    * **down** — ``scale_down_after`` consecutive reconciles with the queue
      near-idle (<= 25% of target) and past ``down_cooldown_s``: desired
      drops by ONE (drain the newest worker) — down is deliberately linear
      and slow, a flapping fleet is worse than a briefly oversized one;
    * **replace** — live < desired for any reason (crash, OOM, kill -9):
      spawned back within the SAME reconcile pass.
    """

    def __init__(self, spec: FleetSpec, launcher: WorkerLauncher,
                 front=None, worker_registry=None,
                 signals_fn=None, clock=time.monotonic,
                 stats_timeout_s: float = 2.0,
                 drain_timeout_s: float = 30.0):
        self.spec = spec
        self.launcher = launcher
        self.front = front
        self.worker_registry = worker_registry
        self.clock = clock
        self.stats_timeout_s = float(stats_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._signals_fn = signals_fn or self._default_signals
        self._handles: dict[str, list[WorkerHandle]] = {
            slo.model: [] for slo in spec.models}
        self._draining: list[WorkerHandle] = []
        self._state: dict[str, _ModelState] = {
            slo.model: _ModelState(slo.min_workers) for slo in spec.models}
        self._last_reconcile_at: float | None = None
        self.worker_seconds: dict[str, float] = {
            slo.model: 0.0 for slo in spec.models}
        self.events: list[dict] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- introspection -----------------------------------------------------
    def live_handles(self, model: str) -> list[WorkerHandle]:
        with self._lock:
            return [h for h in self._handles.get(model, ())
                    if self.launcher.alive(h)]

    def actual(self, model: str) -> int:
        return len(self.live_handles(model))

    def desired(self, model: str) -> int:
        with self._lock:
            return self._state[model].desired

    def wait_ready(self, model: str, n: int, timeout_s: float = 60.0) -> None:
        """Block until ``n`` workers of ``model`` are REGISTERED (routable),
        not merely spawned — the scale-up completion point."""
        if self.worker_registry is None:
            raise RuntimeError("wait_ready needs a worker_registry")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = sum(1 for w in self.worker_registry.workers()
                      if w.get("model") == model)
            if got >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"{n} worker(s) of {model!r} not registered "
                           f"within {timeout_s}s")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            handles = [h for hs in self._handles.values() for h in hs]
            handles += list(self._draining)
        draining: list[WorkerHandle] = []
        for h in handles:
            if drain and self.launcher.alive(h):
                self._backfill_endpoints(h.model, [h])
                if self.launcher.drain(h, timeout_s=self.drain_timeout_s):
                    draining.append(h)  # reap only AFTER the drain window
                else:
                    self.launcher.kill(h)
            elif self.launcher.alive(h):
                self.launcher.kill(h)
            if h not in draining:
                self.launcher.reap(h)
        if draining:
            # a drain POST returns immediately; the worker finishes its
            # backlog asynchronously for up to drain_timeout_s — reaping
            # (which escalates to SIGKILL) before that window closes would
            # abandon the very exchanges the drain promised to finish
            deadline = time.monotonic() + self.drain_timeout_s + 5.0
            while time.monotonic() < deadline and \
                    any(self.launcher.alive(h) for h in draining):
                time.sleep(0.05)
            for h in draining:
                if self.launcher.alive(h):
                    self.launcher.kill(h)
                self.launcher.reap(h)
        with self._lock:
            for hs in self._handles.values():
                hs.clear()
            self._draining.clear()
        # belt-and-suspenders for the join-timeout race: if an in-flight
        # reconcile pass outlived the join and spawned after the snapshot
        # above, the launcher still owns every worker it ever started
        self.launcher.close()

    def _run(self) -> None:
        while not self._stop.wait(self.spec.reconcile_interval_s):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must survive a bad
                pass           # signal read; the next tick retries

    # -- signals -----------------------------------------------------------
    def _default_signals(self, slo: ModelSLO,
                         live: list[WorkerHandle]) -> FleetSignals:
        self._backfill_endpoints(slo.model, live)
        depths = []
        hit_rates = []
        for h in live:
            if h.endpoint is None:
                continue
            try:
                with urllib.request.urlopen(
                        h.endpoint + "/admin/stats",
                        timeout=self.stats_timeout_s) as r:
                    stats = json.loads(r.read())
                depths.append(float(stats.get("queue_depth", 0)))
                h.state = "ready"
            except (urllib.error.URLError, OSError, ValueError):
                continue  # unreachable mid-poll: the breaker plane's job
            # LLM workers surface engine stats under "llm" (serve_llm sets
            # server.llm_stats_fn); absent/odd shapes just skip the signal
            try:
                rate = ((stats.get("llm") or {}).get("prefix_cache")
                        or {}).get("hit_rate")
                if rate is not None:
                    hit_rates.append(float(rate))
            except (AttributeError, TypeError, ValueError):
                pass
        p95 = None
        if self.front is not None:
            p95 = (self.front.version_stats().get(slo.model) or {}) \
                .get("p95_ms")
        return FleetSignals(
            queue_per_worker=(sum(depths) / len(depths)) if depths else None,
            p95_ms=p95, workers_polled=len(depths),
            prefix_hit_rate=(sum(hit_rates) / len(hit_rates))
            if hit_rates else None)

    def _backfill_endpoints(self, model: str,
                            live: list[WorkerHandle]) -> None:
        """Subprocess workers register themselves; fill host/port onto the
        handles from the registry table (matched by real pid)."""
        if self.worker_registry is None:
            return
        by_pid = {w.get("pid"): w for w in self.worker_registry.workers()
                  if w.get("model") == model}
        for h in live:
            if h.host is None and h.pid in by_pid:
                w = by_pid[h.pid]
                h.host, h.port = w.get("host"), w.get("port")
                h.state = "ready"

    # -- the reconcile pass ------------------------------------------------
    def reconcile_once(self) -> list[dict]:
        t0 = time.perf_counter()
        events: list[dict] = []
        with obs.get_tracer().span("fleet.reconcile"):
            with self._lock:
                now = self.clock()
                dt = (0.0 if self._last_reconcile_at is None
                      else max(now - self._last_reconcile_at, 0.0))
                self._last_reconcile_at = now
                self._reap_draining(events)
                per_model = [(slo, self._reap_and_bill(slo, dt, events))
                             for slo in self.spec.models]
            # signal polls happen OUTSIDE the lock: N wedged /admin/stats
            # endpoints can stall for N x stats_timeout_s — exactly during
            # the overload being measured — and introspection (actual/
            # desired/live_handles) and stop() must not block on them
            polled = [(slo, live, self._signals_fn(slo, live))
                      for slo, live in per_model]
            with self._lock:
                for slo, live, sig in polled:
                    self._apply_policy(slo, sig, now, events)
            self.events.extend(events)
            del self.events[:-1000]
        _FLEET_METRICS.get()["reconcile_ms"].observe(
            (time.perf_counter() - t0) * 1e3)
        return events

    def _reap_draining(self, events: list[dict]) -> None:
        for h in list(self._draining):
            if not self.launcher.alive(h):
                self._forget(h)
                self._draining.remove(h)
                events.append(self._event(h.model, "drained"))
            elif h.drain_at is not None and \
                    self.clock() - h.drain_at > self.drain_timeout_s:
                self.launcher.kill(h)  # a wedged drain must still converge

    def _forget(self, h: WorkerHandle) -> None:
        if self.worker_registry is not None and h.pid is not None:
            self.worker_registry.remove_pid(h.pid)
        self.launcher.reap(h)

    def _event(self, model: str, direction: str, **extra) -> dict:
        live = [h for h in self._handles.get(model, ())
                if self.launcher.alive(h)]
        ev = {"t": self.clock(), "model": model, "event": direction,
              "desired": self._state[model].desired
              if model in self._state else None,
              "actual": len(live), **extra}
        _FLEET_METRICS.get()["scale_events"].inc(model=model,
                                                 direction=direction)
        return ev

    def _reap_and_bill(self, slo: ModelSLO, dt: float,
                       events: list[dict]) -> list[WorkerHandle]:
        """Phase 1 (lock held): reap crashed workers — they free their
        slots NOW so the convergence step replaces them in this same pass
        — and integrate the cost. Returns the live handles to poll."""
        handles = self._handles[slo.model]
        for h in list(handles):
            if not self.launcher.alive(h):
                handles.remove(h)
                self._forget(h)
                events.append(self._event(slo.model, "lost",
                                          handle=h.handle_id))
        live = list(handles)
        # cost integral counts DRAINING workers too — they are still
        # running (finishing their backlog) and still bill
        n_billed = len(live) + sum(1 for d in self._draining
                                   if d.model == slo.model)
        self.worker_seconds[slo.model] += dt * n_billed
        _FLEET_METRICS.get()["worker_seconds"].inc(dt * n_billed,
                                                   model=slo.model)
        return live

    def _apply_policy(self, slo: ModelSLO, sig: FleetSignals, now: float,
                      events: list[dict]) -> None:
        """Phase 2 (lock held): signals -> desired -> converge.

        Spawns/drains deliberately stay INSIDE the lock: ``stop()``
        acquires it after joining the loop thread, so an in-flight spawn
        always completes (and lands in ``_handles``) before teardown can
        enumerate what to kill — moving the actions out would reintroduce
        the leaked-worker race. The cost is that introspection can stall
        for one spawn/drain; the drain POST is bounded at 3 s and the
        expensive signal polls already run outside the lock."""
        state = self._state[slo.model]
        handles = self._handles[slo.model]
        live = [h for h in handles if self.launcher.alive(h)]
        overloaded = (
            (sig.queue_per_worker is not None
             and sig.queue_per_worker > slo.target_queue_depth)
            or (slo.p95_slo_ms is not None and sig.p95_ms is not None
                and sig.p95_ms > slo.p95_slo_ms))
        # underload needs EVIDENCE: a pass with no pollable signal (fresh
        # workers not yet registered, stats timeouts — possibly caused by
        # the very overload being measured) must not advance the
        # scale-down streak
        underloaded = (not overloaded
                       and sig.queue_per_worker is not None
                       and sig.queue_per_worker
                       <= 0.25 * slo.target_queue_depth)
        if overloaded:
            state.underload_streak = 0
            if state.desired < slo.max_workers \
                    and now - state.last_up_at >= slo.up_cooldown_s:
                state.desired = min(slo.max_workers,
                                    max(state.desired + 1,
                                        2 * max(len(live), 1)))
                state.last_up_at = now
                events.append(self._event(
                    slo.model, "up",
                    queue=sig.queue_per_worker, p95_ms=sig.p95_ms))
        elif underloaded:
            state.underload_streak += 1
            if state.underload_streak >= slo.scale_down_after \
                    and state.desired > slo.min_workers \
                    and now - state.last_down_at >= slo.down_cooldown_s:
                state.desired -= 1
                state.last_down_at = now
                state.underload_streak = 0
                events.append(self._event(slo.model, "down",
                                          queue=sig.queue_per_worker))
        else:
            state.underload_streak = 0
        state.desired = min(max(state.desired, slo.min_workers),
                            slo.max_workers)
        # 3. converge live toward desired — but never spawn once stop()
        # has been requested (a late spawn could outlive the teardown
        # snapshot; launcher.close() in stop() is the last-resort net)
        if self._stop.is_set():
            return
        while len(handles) < state.desired:
            try:
                handle = self.launcher.spawn(slo)
            except Exception as e:  # noqa: BLE001 — a failed spawn must not
                events.append(self._event(        # kill the control loop
                    slo.model, "spawn_failed", error=f"{type(e).__name__}"))
                break
            handles.append(handle)
            events.append(self._event(slo.model, "spawn",
                                      handle=handle.handle_id))
        while len(handles) > state.desired:
            victim = max(handles, key=lambda h: h.spawned_at)  # newest first
            handles.remove(victim)
            victim.state = "draining"
            victim.drain_at = self.clock()
            self._backfill_endpoints(slo.model, [victim])
            if self.launcher.drain(victim,
                                   timeout_s=self.drain_timeout_s):
                self._draining.append(victim)
                events.append(self._event(slo.model, "drain",
                                          handle=victim.handle_id))
            else:  # unreachable: treat as crashed
                self.launcher.kill(victim)
                self._forget(victim)
                events.append(self._event(slo.model, "drain_kill",
                                          handle=victim.handle_id))
        m = _FLEET_METRICS.get()
        m["desired"].set(state.desired, model=slo.model)
        m["actual"].set(len(handles), model=slo.model)
