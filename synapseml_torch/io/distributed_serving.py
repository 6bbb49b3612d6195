"""Distributed serving: per-worker HTTP servers + driver routing front.

Counterpart of ``synapseml_tpu/io/distributed_serving.py``; the front, the
journal, the transport and the supervisor are the reference's host code.
Where the port differs: a worker is a fresh interpreter
(``subprocess.Popen``, never a fork of a parent that may hold a CUDA
context) that opens its own context on the card and serves on its stages'
``device``; a stage that names the card on a host without one raises at
worker start instead of serving on the CPU. ``llm_worker_main`` takes the
stage's ``device`` (default ``"cuda"``).

Reference: ``streaming/DistributedHTTPSource.scala:88-203`` — every executor
runs a ``JVMSharedServer`` and requests are served wherever they land, with
the driver service collecting worker endpoints
(``DriverServiceUtils``, ``continuous/HTTPSourceV2.scala:132-202``). Here:

  * ``worker_main`` — one OS process per partition-worker, running
    ``serve_pipeline`` on its own port and registering (host, port) with the
    driver registry;
  * ``WorkerRegistry`` — the driver-side registration endpoint (worker list =
    the routing table);
  * ``RoutingFront`` — the one public port: forwards each request round-robin
    to a live worker, skipping dead ones (the shared-server role).

``serve_pipeline_distributed`` wires all three and returns the front.
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import json
import os
import pickle
import queue
import random
import socket
import subprocess
import sys
import threading
import time
import itertools
import urllib.error
import urllib.request
import uuid
import weakref
from http.server import BaseHTTPRequestHandler

from ..core import batching as cb
from ..core import faults as _faults
from ..core import observability as obs
from ..core.resilience import CircuitBreaker, resilience_measures
# the fleet plane owns the model-path and priority-class conventions; one
# definition each (fleet modules import io lazily, so no cycle)
from ..fleet.admission import priority_of as _priority_of
from ..fleet.residency import model_from_path as _model_of_path
from .serving import NoDelayHTTPServer

__all__ = ["WorkerRegistry", "RoutingFront", "RoutingClient",
           "serve_pipeline_distributed", "worker_main", "llm_worker_main",
           "deregister_worker", "collect_distributed_trace"]


def deregister_worker(registry_address: str, info: dict,
                      timeout_s: float = 10.0) -> bool:
    """POST a worker's registration info to the registry's ``/deregister``
    endpoint — the ONE graceful-removal call both worker entrypoints
    (``worker_main`` here, ``fleet_worker_main``) and the in-process fleet
    launcher share, so the deregister contract cannot drift between them.
    ``registry_address`` may be the ``/register`` URL or the bare registry
    address (the handler only branches on a ``deregister`` suffix).
    Best-effort: an unreachable registry returns False, never raises —
    the caller is about to exit either way."""
    base = str(registry_address).rstrip("/")
    dereg = (base[:-len("/register")] if base.endswith("/register")
             else base) + "/deregister"
    try:
        urllib.request.urlopen(urllib.request.Request(
            dereg, data=json.dumps(info).encode(), method="POST",
            headers={"Content-Type": "application/json"}),
            timeout=timeout_s).read()
        return True
    except (urllib.error.URLError, OSError):
        return False

_BREAKER_STATE_NUM = {CircuitBreaker.CLOSED: 0.0,
                      CircuitBreaker.HALF_OPEN: 1.0,
                      CircuitBreaker.OPEN: 2.0}

# distinct label per RoutingFront/RoutingClient instance: two live owners
# sharing a worker endpoint must not emit duplicate series (a Prometheus
# scrape rejects identical label sets)
_BREAKER_OWNER_IDS = itertools.count(1)


def _register_breaker_gauge(owner, plane: str,
                            instance: str | None = None) -> None:
    """Pull-time ``synapseml_breaker_state`` gauge per worker endpoint
    (0=closed, 1=half-open, 2=open) for a RoutingFront/RoutingClient.
    Weakref'd: a collected owner silently stops exporting. ``instance``
    lets one owner share ITS id across several collectors (the front's
    breaker + split gauges must correlate on a dashboard)."""
    ref = weakref.ref(owner)
    reg = obs.get_registry()
    if instance is None:
        instance = str(next(_BREAKER_OWNER_IDS))

    def collect():
        o = ref()
        if o is None:  # owner collected: self-unregister so a long session
            reg.unregister_collector(collect)  # doesn't accumulate dead fns
            return
        for endpoint, state in o.breaker_states().items():
            yield obs.Sample(
                "synapseml_breaker_state",
                {"plane": plane, "endpoint": endpoint, "instance": instance},
                _BREAKER_STATE_NUM.get(state, -1.0),
                help="per-worker circuit breaker state "
                     "(0=closed, 1=half-open, 2=open)")

    reg.register_collector(collect)


# hot routing-path metric handles (see HandleCache: one identity check per
# request instead of registry get-or-create lock traffic)
_ROUTE_METRICS = obs.HandleCache(lambda reg: {
    "pick_ms": reg.histogram(
        "synapseml_route_pick_ms",
        "time to pick the first candidate worker").labels(),
    "retries": reg.counter(
        "synapseml_route_retries_total",
        "rerouted forwards after a worker failure").labels(),
    "worker_failures": reg.counter(
        "synapseml_route_worker_failures_total",
        "forward attempts that failed, per worker", ("worker",)),
    "request_ms": reg.histogram(
        "synapseml_route_request_duration_ms",
        "routed request latency, per worker", ("worker",)),
    "unroutable": reg.counter(
        "synapseml_route_unroutable_total",
        "requests that exhausted every worker").labels(),
    # deployment plane: per-version series (canary observability) — the
    # acceptance surface for registry/deploy.py rollout decisions
    "version_requests": reg.counter(
        "synapseml_route_version_requests_total",
        "routed requests per pipeline version", ("version", "status")),
    "version_ms": reg.histogram(
        "synapseml_route_version_request_ms",
        "routed request latency per pipeline version", ("version",)),
    "shadow_requests": reg.counter(
        "synapseml_route_shadow_requests_total",
        "shadow-traffic duplicates per version", ("version", "status")),
    "shadow_delta_ms": reg.histogram(
        "synapseml_route_shadow_latency_delta_ms",
        "shadow latency minus primary latency for the same request",
        ("version",)),
    # continuous-batching coalescer: how full the same-path groups run and
    # how much padding the workers' bucket ladder will spend on them
    "bucket_occupancy": reg.histogram(
        "synapseml_route_bucket_occupancy",
        "requests per coalesced same-path group released to one worker",
        ("version",), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    "padded_rows": reg.counter(
        "synapseml_route_padded_rows_total",
        "rows of bucket padding the released group sizes imply",
        ("version",)),
    "real_rows": reg.counter(
        "synapseml_route_real_rows_total",
        "real request rows released through the coalescer", ("version",)),
})


class _VersionStats:
    """Monotonic per-version counters + a bounded latency window, kept by
    the RoutingFront so the auto-rollback controller (registry/deploy.py)
    and the fleet autoscaler can diff outcomes without scraping the
    Prometheus text format. The fleet plane adds per-PRIORITY state: how
    many requests of each class are in flight through the front right now
    (the front-side queue depth) and how many the admission controller
    shed (monotonic, reconcilable with client-observed 429s)."""

    __slots__ = ("ok", "err", "shadow_ok", "shadow_err", "latencies_ms",
                 "inflight", "shed")

    def __init__(self):
        self.ok = 0
        self.err = 0
        self.shadow_ok = 0
        self.shadow_err = 0
        self.latencies_ms = collections.deque(maxlen=256)
        self.inflight = {"interactive": 0, "bulk": 0}
        self.shed = {"interactive": 0, "bulk": 0}

    def snapshot(self) -> dict:
        lat = list(self.latencies_ms)
        out = {"ok": self.ok, "err": self.err,
               "shadow_ok": self.shadow_ok, "shadow_err": self.shadow_err,
               "n_latencies": len(lat),
               "inflight": dict(self.inflight), "shed": dict(self.shed)}
        if lat:
            lat.sort()
            out["p50_ms"] = round(lat[len(lat) // 2], 3)
            out["p95_ms"] = round(lat[min(len(lat) - 1,
                                          int(len(lat) * 0.95))], 3)
        return out


def _version_of(w: dict) -> str:
    """A worker registration's pipeline version label (canary routing /
    per-version metrics); unlabeled fleets collapse to one series."""
    return str(w.get("version") or "unversioned")


def _hosts_model(w: dict, model: str) -> bool:
    """Does this worker registration advertise ``model``? (Single-model
    fleet workers register ``model``; multi-model residency workers may
    register a ``models`` list.)"""
    if w.get("model") == model:
        return True
    models = w.get("models")
    return isinstance(models, (list, tuple)) and model in models


def _model_aware(w: dict) -> bool:
    """Does this registration carry ANY model info (single-model ``model``
    or multi-model ``models``)?"""
    return w.get("model") is not None \
        or isinstance(w.get("models"), (list, tuple))


def _eligible_for_model(w: dict, model: str, fleet_labeled: bool) -> bool:
    """Can this worker SERVE ``model`` at all? A single-model worker
    registered for a DIFFERENT model is ineligible — forwarding a /m/B
    request to model A's pipeline would return A's prediction with a 200,
    a silent wrong answer worse than a 503. Multi-model residency workers
    (a ``models`` list, even empty — they load on demand) stay eligible.
    Model-less legacy registrations are eligible ONLY on an unlabeled
    fleet (``fleet_labeled`` False — pre-fleet deployments that happen to
    use /m/ paths keep working); once any worker advertises model info,
    an unlabeled worker serving who-knows-what must not catch model
    traffic the labeled workers dropped."""
    if _hosts_model(w, model):
        return True
    if isinstance(w.get("models"), (list, tuple)):
        return True
    return w.get("model") is None and not fleet_labeled


_PREFIX_SIG_TOKENS = 16   # token-id requests: sig over the first 16 ids
# (one default KV block's worth — long enough to separate unrelated
# prompts, short enough that family members diverging after a shared
# system-prompt head still hash to the SAME worker)
_PREFIX_SIG_CHARS = 256   # text requests: sig over the first 256 chars


def _prefix_sig(body) -> "str | None":
    """Stable signature of a generation request's prompt HEAD — the
    rendezvous key for prefix-affinity routing. Hashing only the head (a
    block's worth of tokens / a system-prompt's worth of text) is the
    point: requests that SHARE a prefix but diverge later must map to the
    same worker, so the divergent tail stays out of the key. Non-JSON and
    non-generation bodies return None (no affinity, plain rotation)."""
    if body is None:
        return None
    if isinstance(body, (bytes, bytearray)):
        try:
            body = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None
    if not isinstance(body, dict):
        return None
    ids = body.get("input_ids")
    if isinstance(ids, (list, tuple)) and ids:
        try:
            head = ",".join(str(int(t)) for t in ids[:_PREFIX_SIG_TOKENS])
        except (TypeError, ValueError):
            return None
        return hashlib.md5(f"ids|{head}".encode()).hexdigest()
    prompt = body.get("prompt")
    if isinstance(prompt, str) and prompt:
        return hashlib.md5(
            f"txt|{prompt[:_PREFIX_SIG_CHARS]}".encode()).hexdigest()
    return None


def _register_split_gauge(front, instance: str) -> None:
    """Pull-time ``synapseml_route_split_weight`` gauge per version: the
    active canary/traffic split, visible on ``/metrics`` so dashboards see
    rollout state without scraping admin endpoints. Weakref'd like the
    breaker gauge; a cleared split simply stops exporting. ``instance``
    is the owning front's id — the same label its breaker gauge carries."""
    ref = weakref.ref(front)
    reg = obs.get_registry()

    def collect():
        o = ref()
        if o is None:
            reg.unregister_collector(collect)
            return
        for version, weight in (o.traffic_split() or {}).items():
            yield obs.Sample(
                "synapseml_route_split_weight",
                {"version": version, "instance": instance}, weight,
                help="active traffic-split weight per pipeline version "
                     "(normalized; absent = no split active)")

    reg.register_collector(collect)


def _nodelay_connection(host: str, port: int,
                        timeout_s: float) -> http.client.HTTPConnection:
    """Persistent client connection with TCP_NODELAY (see NoDelayHTTPServer:
    keep-alive + Nagle + delayed ACK = ~40 ms per small request otherwise)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


class WorkerRegistry:
    """Driver-side worker registration (DriverServiceUtils analog): workers
    POST {host, port, pid}; the routing table is the registered list. A
    re-registration from the same (host, port) replaces the old entry, so a
    restarted worker rejoins cleanly. ``POST .../deregister`` removes the
    entry — a gracefully DRAINED worker (fleet plane, ``/admin/drain``)
    leaves the table deliberately, so its disappearance is no longer
    indistinguishable from a crash."""

    def __init__(self):
        self._workers: list[dict] = []
        self._lock = threading.Lock()
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                info = json.loads(self.rfile.read(n))
                key = (info.get("host"), info.get("port"))
                with registry._lock:
                    registry._workers = [
                        w for w in registry._workers
                        if (w.get("host"), w.get("port")) != key]
                    if not self.path.rstrip("/").endswith("deregister"):
                        registry._workers.append(info)
                body = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = NoDelayHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def workers(self) -> list[dict]:
        with self._lock:
            return list(self._workers)

    def remove_pid(self, pid: int) -> None:
        """Drop a worker whose process is known dead (supervisor callback)."""
        with self._lock:
            self._workers = [w for w in self._workers if w.get("pid") != pid]

    def wait_for(self, n: int, timeout_s: float = 60.0) -> list[dict]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            w = self.workers()
            if len(w) >= n:
                return w
            time.sleep(0.05)
        raise TimeoutError(f"only {len(self.workers())}/{n} workers registered")

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class _ConnPool:
    """Persistent per-worker HTTP connections (keep-alive): forwarding a
    request costs one loopback write/read, not a TCP handshake + teardown."""

    def __init__(self, timeout_s: float, max_idle_per_key: int = 32):
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self._timeout_s = timeout_s
        self._max_idle = max_idle_per_key

    def get(self, key: tuple):
        """(connection, fresh) — a pooled keep-alive connection when one is
        idle, else a freshly connected TCP_NODELAY one (raises OSError when
        the worker is unreachable). An active fault plan (``core/faults.py``)
        may inject a connect failure / crash / blackhole here — the hook sits
        before the pool so injected faults hit pooled connections too."""
        plan = _faults.active_fault_plan()
        if plan is not None:
            plan.on_connect(key)
        with self._lock:
            stack = self._idle.get(key)
            if stack:
                return stack.pop(), False
        return _nodelay_connection(key[0], key[1], self._timeout_s), True

    def put(self, key: tuple, conn) -> None:
        with self._lock:
            stack = self._idle.setdefault(key, [])
            if len(stack) < self._max_idle:
                stack.append(conn)
                return
        conn.close()

    def clear(self, key: tuple) -> None:
        with self._lock:
            stack = self._idle.pop(key, [])
        for c in stack:
            c.close()

    def close(self) -> None:
        with self._lock:
            conns = [c for stack in self._idle.values() for c in stack]
            self._idle.clear()
        for c in conns:
            c.close()


def _pooled_request(pool: _ConnPool, key: tuple, method: str, path: str,
                    body, headers: dict | None):
    """(status, payload) over a pooled keep-alive connection.

    A stale pooled connection (worker restarted / idle-closed) drops every
    idle connection for the key and retries ONCE on a fresh one; a fresh
    connection failing means the worker is genuinely unreachable, and the
    exception propagates to the caller. Shared by the RoutingFront proxy
    and the RoutingClient so the retry semantics cannot diverge."""
    for _ in range(2):
        conn, fresh = None, True
        try:
            conn, fresh = pool.get(key)
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            payload = r.read()
        except (http.client.HTTPException, OSError):
            if conn is not None:
                conn.close()
            if fresh:
                raise
            pool.clear(key)
            continue
        if r.will_close:
            conn.close()
        else:
            pool.put(key, conn)
        return r.status, payload
    raise ConnectionError(f"worker {key} failed on a fresh connection")


class _CoalesceGroup:
    """One batch-in-flight of same-path requests: all members forward to the
    same candidate ordering, so the chosen worker's continuous-batching
    scheduler drains them as one bucket-sized batch."""

    __slots__ = ("path", "count", "closed", "release", "lock", "candidates",
                 "desperate")

    def __init__(self, path: str):
        self.path = path
        self.count = 0
        self.closed = False
        self.release = threading.Event()
        self.lock = threading.Lock()
        self.candidates = None
        self.desperate = False


class _RequestCoalescer:
    """Groups same-path requests arriving within ``window_s`` so they land
    on the SAME worker back-to-back instead of round-robining one row to
    every worker in the fleet. The first joiner (leader) holds the group
    open until a full bucket's worth (``max_group``) joins or the window
    expires; followers ride the leader's release. Occupancy and the padding
    the workers' bucket ladder will spend on each released group are
    exported per version (``synapseml_route_bucket_occupancy`` /
    ``_padded_rows_total`` / ``_real_rows_total``)."""

    def __init__(self, window_s: float, max_group: int = 64):
        self.window_s = float(window_s)
        self.max_group = int(max_group)
        self._lock = threading.Lock()
        self._open: dict[str, _CoalesceGroup] = {}

    def join(self, path: str) -> _CoalesceGroup:
        with self._lock:
            group = self._open.get(path)
            leader = group is None or group.closed
            if leader:
                group = self._open[path] = _CoalesceGroup(path)
            group.count += 1
            if group.count >= self.max_group:
                group.closed = True
                if self._open.get(path) is group:
                    del self._open[path]
                group.release.set()
        if leader:
            group.release.wait(self.window_s)
            with self._lock:
                group.closed = True
                if self._open.get(path) is group:
                    del self._open[path]
            group.release.set()
        else:
            # followers outwait the leader slightly; a lost wakeup degrades
            # to forwarding solo, never to a dropped request
            group.release.wait(self.window_s + 0.25)
        return group


# survivable-LLM plane: journal/migration/hedging metric handles
_JOURNAL_METRICS = obs.HandleCache(lambda reg: {
    "resubmits": reg.counter(
        "synapseml_llm_resubmits_total",
        "journaled generations resubmitted to another worker (mode: "
        "import = adopted a migrated KV snapshot, resume = re-prefilled "
        "over prompt + already-relayed tokens after a crash)", ("mode",)),
    "replays": reg.counter(
        "synapseml_llm_journal_replays_total",
        "terminal results replayed from the front journal for a retried "
        "idempotency key — the dedup that makes a retried non-streaming "
        "request generate at most once").labels(),
    "hedges": reg.counter(
        "synapseml_llm_hedges_total",
        "hedged generation attempts fired after a stuck prefill, by "
        "arbitration outcome (won = the hedge produced the stream, "
        "lost = the primary recovered first)", ("outcome",)),
})


class _ClientGone(Exception):
    """The front->client socket died while relaying a journaled stream."""


class _JournalEntry:
    """One journaled generation: everything the RoutingFront needs to
    splice a migrated stream or re-create a crashed one on another worker
    without the client noticing. ``relayed`` is the next expected GLOBAL
    token index — worker chunks carry ``seq`` (the token's global index),
    so any chunk below ``relayed`` is a duplicate from a resume overlap
    and is dropped before it reaches the client."""

    __slots__ = ("key", "digest", "body", "client_stream", "relayed",
                 "emitted_ids", "uid", "worker", "done", "result", "status",
                 "mailbox", "deadline", "lock", "inflight", "winner")

    def __init__(self, key: str, digest: str, body: dict,
                 client_stream: bool, deadline: float | None):
        self.key = key
        self.digest = digest              # sha256 of the client body
        self.body = body                  # original client payload
        self.client_stream = client_stream
        self.relayed = 0
        self.emitted_ids: list[int] = []  # every token id relayed so far
        self.uid = None                   # origin engine uid (sampling
        #                                   streams fold on it)
        self.worker = None                # endpoint currently assigned
        self.done = False
        self.result = None                # terminal record, replayable
        self.status = 200
        self.mailbox = None               # migrated KV snapshot, if any
        self.deadline = deadline          # absolute monotonic, or None
        self.lock = threading.Lock()
        self.inflight = False
        self.winner = None                # hedge arbitration: attempt id


class _StreamJournal:
    """Bounded per-request journal keyed by idempotency key. DONE entries
    evict LRU-first past ``max_entries``; live entries are never evicted
    (evicting one would orphan a client mid-stream)."""

    def __init__(self, max_entries: int = 1024):
        self._entries: "collections.OrderedDict[str, _JournalEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._max = int(max_entries)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str) -> "_JournalEntry | None":
        with self._lock:
            return self._entries.get(key)

    def admit(self, key: str, digest: str, body: dict, client_stream: bool,
              deadline: float | None):
        """(entry, verdict) — verdict ``new`` starts a generation,
        ``replay`` returns the recorded terminal result (retried key, same
        prompt), ``conflict`` rejects a key that is still in flight (a
        concurrent duplicate must not race the original's stream)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                if not e.done and e.inflight:
                    return e, "conflict"
                if e.digest == digest and e.done:
                    self._entries.move_to_end(key)
                    return e, "replay"
                # same key, different prompt (or a dead unfinished entry):
                # the reuse is a NEW request — replace the record
            e = _JournalEntry(key, digest, body, client_stream, deadline)
            self._entries[key] = e
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                victim = next((k for k, v in self._entries.items()
                               if v.done and k != key), None)
                if victim is None:
                    break
                del self._entries[victim]
            return e, "new"


def _register_journal_gauge(front, instance: str) -> None:
    """Pull-time ``synapseml_llm_journal_depth`` gauge (weakref'd like the
    breaker gauge: a collected front silently stops exporting)."""
    ref = weakref.ref(front)
    reg = obs.get_registry()

    def collect():
        o = ref()
        if o is None:
            reg.unregister_collector(collect)
            return
        j = o._journal
        if j is not None:
            yield obs.Sample(
                "synapseml_llm_journal_depth", {"instance": instance},
                float(j.depth()),
                help="journaled generations held by the routing front "
                     "(bounded; done entries evict LRU-first)")

    reg.register_collector(collect)


class _StreamWriter:
    """Relays worker chunks to ONE client with seq-dedup and hedge
    arbitration. Every delivery runs under the entry lock: the first
    attempt to land a chunk claims the stream (first-writer-wins); the
    losing attempt is told so and closes its worker connection. Dedup is
    by global token index, so interleaved writes from a resumed attempt
    overlapping a dying one still reach the client exactly once, in
    order."""

    def __init__(self, handler, entry: _JournalEntry):
        self._h = handler
        self.entry = entry
        self.began = False

    def _begin(self) -> None:
        h = self._h
        h.send_response(200)
        h.send_header("Content-Type", "application/x-ndjson")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        self.began = True

    def _write(self, obj) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self._h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self._h.wfile.flush()

    def deliver(self, chunk: dict, attempt_id: int) -> str:
        """'ok' | 'dup' | 'lost'; raises _ClientGone on a dead client."""
        e = self.entry
        with e.lock:
            if e.winner is None:
                e.winner = attempt_id
            elif e.winner != attempt_id:
                return "lost"
            if chunk.get("uid") is not None:
                e.uid = chunk["uid"]
            done = bool(chunk.get("done"))
            seq = chunk.get("seq")
            if not done and "token" in chunk:
                if seq is not None and seq < e.relayed:
                    return "dup"
                e.emitted_ids.append(chunk["token"])
                e.relayed = (seq + 1) if seq is not None else e.relayed + 1
            elif done:
                if e.done:
                    return "dup"
                e.done = True
                e.result = chunk
            if e.client_stream:
                if not self.began:
                    self._begin()
                try:
                    self._write(chunk)
                except OSError:
                    raise _ClientGone from None
            return "ok"

    def finish_stream(self) -> None:
        if not self.began:
            return
        try:
            self._h.wfile.write(b"0\r\n\r\n")
            self._h.wfile.flush()
        except OSError:
            pass


class RoutingFront:
    """One public port; round-robin forwarding to live workers over
    PERSISTENT (keep-alive) worker connections; ``GET /routes`` returns the
    live routing table as JSON so clients can switch to direct per-worker
    connections (serve-where-it-lands, the ``DistributedHTTPSource`` model
    where requests are served wherever they land).

    Reliability semantics (the reference's serve-where-it-lands plane never
    loses workers permanently, ``DistributedHTTPSource.scala:88-203``), built
    on per-worker ``core.resilience.CircuitBreaker``s:

    * connect failures AND timeouts trip the worker's breaker OPEN (the
      any-failure configuration: threshold 0, window 1); an open breaker is
      skipped for ``resurrect_after_s`` seconds, after which it moves to
      HALF-OPEN and the worker is probed again (time-based resurrection — a
      slow-but-alive worker is excluded only briefly, while a blackholed one
      stops stalling every rotation by ``timeout_s``); any successful reply
      closes the breaker immediately;
    * when every worker's breaker is open the least-recently-failed one is
      probed anyway (the front degrades to retrying, never to a permanent
      503);
    * with a ``registry``, the routing table refreshes from it on every
      request, so workers registered AFTER startup (restarts, scale-up) are
      routed to immediately; a static ``workers`` list is merged in (the
      registry entry wins on a (host, port) collision);
    * ``GET /stats`` reports the ``distributed_serving`` resilience counters
      (retries, breaker opens, deadline expiries, injected faults) plus the
      live per-worker breaker states.

    Deployment plane (``registry/deploy.py``): workers may register with a
    ``version``; ``set_traffic_split({"v1": 0.9, "v2": 0.1})`` routes each
    request to a version drawn by weight (canary), falling back to any live
    worker when the drawn version has none (a dying canary degrades to the
    stable fleet, never to a 503); ``set_shadow(version)`` duplicates
    requests to a worker of that version in the background, discards the
    response, and records latency/error deltas. Per-version request/latency
    /error series land in the metrics registry; ``version_stats()``
    snapshots monotonic per-version counters for the auto-rollback
    controller. ``POST /admin/split`` applies a split/shadow over HTTP.
    """

    def __init__(self, workers: list[dict] | None = None, port: int = 0,
                 timeout_s: float = 60.0, registry: "WorkerRegistry" = None,
                 resurrect_after_s: float = 2.0,
                 max_inflight_shadows: int = 8,
                 coalesce_window_ms: float = 0.0,
                 coalesce_max_group: int = 64,
                 admission=None,
                 route_by_model: bool = False,
                 route_by_prefix: bool = False,
                 journal: bool = False,
                 journal_max_entries: int = 1024,
                 hedge_after_s: float | None = None,
                 max_stream_attempts: int = 4):
        if workers is None and registry is None:
            raise ValueError("RoutingFront needs workers and/or a registry")
        # survivable-LLM plane (opt in for LLM fleets): a bounded
        # per-request journal makes every generation resumable — worker
        # death mid-stream resubmits to a healthy worker (re-prefill over
        # prompt + relayed tokens), a live drain splices the migrated KV
        # snapshot in via /admin/migrate, retried idempotency keys replay
        # the recorded terminal instead of generating twice, and a stuck
        # prefill hedges to a second worker (first-writer-wins)
        self._journal = (_StreamJournal(journal_max_entries)
                         if journal else None)
        self._hedge_after_s = hedge_after_s
        self._max_stream_attempts = int(max_stream_attempts)
        # same-path coalescing toward bucket-sized worker batches (0 = off,
        # the latency-neutral default; enable for throughput-bound fleets)
        self._coalescer = (_RequestCoalescer(coalesce_window_ms / 1000.0,
                                             coalesce_max_group)
                           if coalesce_window_ms > 0 else None)
        self._static_workers = list(workers or [])
        self._registry = registry
        self._resurrect_after_s = resurrect_after_s
        self._breakers: dict[tuple, CircuitBreaker] = {}  # (host, port) ->
        self._rr = 0
        self._lock = threading.Lock()
        self._pool = _ConnPool(timeout_s)
        # deployment plane state: canary split, shadow target, per-version
        # accounting (all guarded by _deploy_lock; the split rng is seedable
        # for deterministic tests)
        self._deploy_lock = threading.Lock()
        self._split: dict[str, float] | None = None
        self._shadow: tuple[str, float] | None = None  # (version, fraction)
        self._split_rng = random.Random()
        self._version_stats: dict[str, _VersionStats] = {}
        self._shadow_sem = threading.Semaphore(max_inflight_shadows)
        # fleet plane: the admission controller (per-model token buckets,
        # priority classes, p99 shedding — fleet/admission.py) consulted
        # BEFORE any worker is picked, and model-segment routing: a
        # ``/m/<model>`` path prefers workers advertising that model
        # (rendezvous-ordered when none do, so multi-model residency
        # workers pack stably instead of thrashing their LRU)
        self._admission = admission
        self.route_by_model = bool(route_by_model)
        # prefix-affinity routing (LLM fleets with the engine prefix cache):
        # generation requests rendezvous-order workers by a hash of the
        # prompt HEAD, so requests sharing a system/RAG/few-shot prefix
        # pack onto the same worker and hit its cached KV pages instead of
        # spreading the prefix across the fleet. Composes UNDER model
        # affinity (a worker hosting the named model still wins).
        self.route_by_prefix = bool(route_by_prefix)
        # continual plane: a RequestLogger attached via set_request_logger
        # records every forwarded exchange AFTER the reply is written —
        # sampled + bounded (shed-before-delay), the flywheel's feedstock
        self._request_logger = None
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # client connections persist too

            def log_message(self, *a):
                pass

            def _reply(self, status: int, payload: bytes = b"",
                       extra: dict | None = None) -> None:
                self.send_response(status)
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                if payload:
                    self.wfile.write(payload)

            def _forward(self, method: str):
                # drain the body FIRST — replying with unread body bytes on
                # a keep-alive connection desyncs the next request
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else None
                if self.path == "/routes":  # served here, not forwarded
                    table = json.dumps(front._table()).encode()
                    self._reply(200, table,
                                {"Content-Type": "application/json"})
                    return
                if self.path == "/stats":  # resilience counters + breakers
                    adm = front._admission
                    stats = json.dumps({
                        "resilience": resilience_measures(
                            "distributed_serving").to_dict(),
                        "breakers": front.breaker_states(),
                        "traffic_split": front.traffic_split(),
                        "shadow": front.shadow(),
                        "versions": front.version_stats(),
                        "admission": (adm.stats()
                                      if adm is not None else None)}).encode()
                    self._reply(200, stats,
                                {"Content-Type": "application/json"})
                    return
                if self.path == "/admin/split":  # deployment plane over HTTP
                    status, reply = front._admin_split(method, body)
                    self._reply(status, json.dumps(reply).encode(),
                                {"Content-Type": "application/json"})
                    return
                if self.path == "/admin/migrate":  # drain handoff mailbox
                    status, reply = front._admin_migrate(body)
                    self._reply(status, json.dumps(reply).encode(),
                                {"Content-Type": "application/json"})
                    return
                if method == "POST" and self.path.startswith("/retrieval/"):
                    # retrieval plane: shard fan-out + top-k merge AT the
                    # front (a /m/<index> request would land on ONE holder;
                    # /retrieval/<index> queries every shard's holder)
                    status, reply, hdrs = front._retrieval_fanout(
                        self.path, body)
                    hdrs["Content-Type"] = "application/json"
                    self._reply(status, json.dumps(reply).encode(), hdrs)
                    return
                # GET-gated like io/serving.py: a POST to a pipeline path
                # that happens to be named /metrics still forwards
                if method == "GET" and self.path == "/metrics":
                    payload, ctype = obs.prometheus_exposition()
                    self._reply(200, payload, {"Content-Type": ctype})
                    return
                if method == "GET" and self.path == "/trace":
                    payload = json.dumps(
                        obs.get_tracer().spans_as_dicts()).encode()
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                tracer = obs.get_tracer()
                parent = obs.extract_context(self.headers)
                with tracer.span("route.request",
                                 {"path": self.path, "method": method},
                                 parent=parent):
                    self._route(method, body)

            def _route(self, method: str, body) -> None:
                rm = _ROUTE_METRICS.get()
                model = _model_of_path(self.path)
                label = model or "unversioned"
                priority = _priority_of(self.headers)
                adm = front._admission
                if adm is not None:
                    decision = adm.admit(model or "default", priority)
                    if not decision.admitted:
                        # shed AT the front: a terminal 429 + Retry-After,
                        # before the request costs a worker queue slot
                        front._record_shed(label, priority)
                        payload = json.dumps(
                            {"error": "admission shed",
                             "reason": decision.reason}).encode()
                        self._reply(decision.status or 429, payload, {
                            "Content-Type": "application/json",
                            "Retry-After": str(max(
                                1, int(-(-decision.retry_after_s // 1))))})
                        return
                front._record_inflight(label, priority, +1)
                try:
                    self._route_admitted(method, body, rm, model, priority)
                finally:
                    front._record_inflight(label, priority, -1)

            def _route_admitted(self, method: str, body, rm,
                                model, priority) -> None:
                if front._journal is not None and method == "POST" \
                        and not self.path.startswith("/admin"):
                    # survivable-LLM plane: generation requests relay
                    # through the journal (chunk-level dedup + resubmit);
                    # everything else falls through to plain forwarding
                    if front._journal_route(self, body, rm, model):
                        return
                hdrs = {k: v for k, v in self.headers.items()
                        if k.lower() not in ("host", "connection",
                                             "traceparent")}
                # stitch the forwarded hop to the route.request span: the
                # worker's serving.request span becomes its child
                obs.get_tracer().inject(hdrs)
                if front._coalescer is not None and method == "POST":
                    group = front._coalescer.join(self.path)
                    # t0 starts AFTER the coalesce wait: pick_ms measures
                    # pure worker-pick overhead, not the batching window
                    t0 = time.perf_counter()
                    candidates, desperate = front._group_candidates(group)
                else:
                    t0 = time.perf_counter()
                    sig = (_prefix_sig(body) if front.route_by_prefix
                           and method == "POST" else None)
                    candidates, desperate = front._candidates(
                        model=model, prefix_sig=sig)
                picked = False
                pending_retry = False  # set by a REAL failure only: the
                # next attempt after one counts as a retry; a drain skip
                # does not arm it, so routine scale-down never shows up
                # in the retry counters
                for w in candidates:
                    key = (w.get("host"), w.get("port"))
                    breaker = front._breaker(key)
                    if not desperate and not breaker.allow():
                        continue  # raced shut since the candidate list
                    if pending_retry:
                        resilience_measures("distributed_serving").count("retry")
                        rm["retries"].inc()
                        pending_retry = False
                    if not picked:
                        # worker pick = table refresh + breaker filtering +
                        # rotation, before the first byte is forwarded
                        rm["pick_ms"].observe(
                            (time.perf_counter() - t0) * 1e3)
                        picked = True
                    endpoint = f"{key[0]}:{key[1]}"
                    version = _version_of(w)
                    fwd0 = time.perf_counter()
                    try:
                        got = _pooled_request(front._pool, key, method,
                                              self.path, body, hdrs)
                    except (http.client.HTTPException, OSError):
                        breaker.record_failure()
                        front._pool.clear(key)
                        rm["worker_failures"].inc(worker=endpoint)
                        front._record_version(version, ok=False)
                        rm["version_requests"].inc(version=version,
                                                   status="error")
                        pending_retry = True
                        continue
                    status, payload = got
                    breaker.record_success()  # proven alive
                    if status == 503 \
                            and payload == b'{"error": "worker draining"}':
                        # a DRAINING worker is healthy but leaving (fleet
                        # plane /admin/drain): reroute to the rest of the
                        # fleet instead of surfacing its refusal — scale-
                        # down stays invisible to clients. Not a breaker
                        # failure AND not a retry in the resilience
                        # counters (routine scale-down must not read as
                        # worker failures on a dashboard); the EXACT-body
                        # match cannot false-positive on an application
                        # 503 that merely mentions the phrase. The
                        # registry table drops the worker when its drain
                        # completes.
                        continue
                    elapsed_ms = (time.perf_counter() - fwd0) * 1e3
                    rm["request_ms"].observe(elapsed_ms, worker=endpoint)
                    front._record_version(version, ok=status < 500,
                                          latency_ms=elapsed_ms)
                    front._observe_admission(model, elapsed_ms,
                                             ok=status < 500)
                    rm["version_requests"].inc(
                        version=version,
                        status=f"{status // 100}xx")
                    rm["version_ms"].observe(elapsed_ms, version=version)
                    self._reply(status, payload,
                                {"X-Served-By": str(w.get("pid", "")),
                                 "X-Served-Version": version})
                    logger = front._request_logger
                    if logger is not None:
                        # after _reply: the client already has its bytes —
                        # a sampled log insert cannot delay the exchange
                        logger.log(method=method, path=self.path,
                                   body=body or b"", reply=payload,
                                   status=status, latency_ms=elapsed_ms,
                                   version=version)
                    front._maybe_shadow(method, self.path, body, hdrs,
                                        version, elapsed_ms)
                    return
                rm["unroutable"].inc()
                self._reply(503)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                self._forward("POST")

        self._server = NoDelayHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        # ONE instance id per front, shared by every collector it owns —
        # dashboards correlate its series by this label
        self._instance = str(next(_BREAKER_OWNER_IDS))
        _register_breaker_gauge(self, plane="front",
                                instance=self._instance)
        _register_split_gauge(self, self._instance)
        if self._journal is not None:
            _register_journal_gauge(self, self._instance)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _table(self) -> list[dict]:
        if self._registry is None:
            return self._static_workers
        reg = self._registry.workers()
        seen = {(w.get("host"), w.get("port")) for w in reg}
        return reg + [w for w in self._static_workers
                      if (w.get("host"), w.get("port")) not in seen]

    def _breaker(self, key: tuple) -> CircuitBreaker:
        """Per-worker breaker, created on first sight with the any-failure
        configuration (one connect failure opens; the half-open probe fires
        after ``resurrect_after_s`` — the old resurrection timer)."""
        with self._lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = CircuitBreaker(
                    failure_rate_threshold=0.0, window=1, min_samples=1,
                    probe_interval_s=self._resurrect_after_s,
                    measures=resilience_measures("distributed_serving"),
                    name=f"{key[0]}:{key[1]}")
                self._breakers[key] = breaker
            return breaker

    def breaker_states(self) -> dict:
        """(host:port -> breaker state) snapshot, for ``/stats``."""
        with self._lock:
            return {f"{h}:{p}": br.state
                    for (h, p), br in self._breakers.items()}

    def _candidates(self, model: str | None = None,
                    prefix_sig: str | None = None) -> tuple[list[dict], bool]:
        """(routing order for one request, desperate): breaker-available
        (closed or probe-due) workers round-robin rotated; if none, the
        least-recently-failed worker as a desperation probe. With a traffic
        split active, a version is drawn by weight and its workers are
        ordered FIRST; every other live worker follows as fallback — a
        canary whose workers all failed degrades to the stable fleet
        instead of dropping the request.

        ``model`` (a ``/m/<model>`` path segment, fleet plane) adds model
        affinity ON TOP: workers advertising the model order first; when
        NONE advertise it and ``route_by_model`` is set, candidates order
        by a stable rendezvous hash of (model, endpoint) instead of the
        rotation — every request for one model lands on the same worker
        first, so multi-model residency workers pack a consistent subset
        instead of thrashing their LRU across the fleet.

        ``prefix_sig`` (``route_by_prefix`` fleets, the engine prefix-cache
        plane) rendezvous-orders workers by hash of (sig, endpoint) BELOW
        the model/version preferences: requests sharing a prompt head land
        on the same worker first, so its prefix cache accumulates hits
        instead of every worker cold-prefilling the same system prompt."""
        full_table = self._table()
        # breaker pruning keys off the FULL table — a model-filtered view
        # must not evict other models' workers' breakers
        live_keys = {(w.get("host"), w.get("port")) for w in full_table}
        with self._lock:
            # prune breakers for departed workers (respawns land on fresh
            # ephemeral ports; without this the map grows forever)
            if len(self._breakers) > len(live_keys):
                self._breakers = {k: b for k, b in self._breakers.items()
                                  if k in live_keys}
        table = full_table
        if model is not None:
            # a request that NAMES a model must never be answered by a
            # different model's pipeline: drop ineligible workers outright
            # (no eligible worker = honest 503, not a wrong 200)
            labeled = any(_model_aware(w) for w in full_table)
            table = [w for w in full_table
                     if _eligible_for_model(w, model, labeled)]
        if not table:
            return [], False
        alive = [w for w in table
                 if self._breaker((w.get("host"), w.get("port"))).available()]
        with self._lock:
            self._rr += 1
            rot = self._rr % max(len(alive), 1)
        if alive:
            ordered = alive[rot:] + alive[:rot]
            if prefix_sig is not None and self.route_by_prefix:
                # applied FIRST so the stable version/model partitions
                # below preserve the prefix order within each tier —
                # affinity composes as model > version > prefix
                def prank(w):
                    key = f"{prefix_sig}|{w.get('host')}:{w.get('port')}"
                    return hashlib.md5(key.encode()).hexdigest()

                ordered = sorted(ordered, key=prank)
            chosen = self._draw_version()
            if chosen is not None:
                preferred = [w for w in ordered
                             if _version_of(w) == chosen]
                ordered = preferred + [w for w in ordered
                                       if _version_of(w) != chosen]
            if model is not None:
                hosting = [w for w in ordered if _hosts_model(w, model)]
                if hosting:
                    ordered = hosting + [w for w in ordered
                                         if not _hosts_model(w, model)]
                elif self.route_by_model:
                    # rendezvous: stable per-model order (hash, not the
                    # rotation) so on-demand residency stays sticky
                    def rank(w):
                        key = f"{model}|{w.get('host')}:{w.get('port')}"
                        return hashlib.md5(key.encode()).hexdigest()

                    ordered = sorted(ordered, key=rank)
            return ordered, False
        # everything recently failed: probe the stalest failure anyway
        stalest = min(table, key=lambda w: self._breaker(
            (w.get("host"), w.get("port"))).last_failure_at or 0.0)
        return [stalest], True

    def _group_candidates(self, group: "_CoalesceGroup"):
        """One candidate ordering per coalesced group — every member
        forwards to the same worker first, so the worker's serve loop sees
        the whole group as one micro-batch. The first member to arrive here
        also accounts the group's occupancy/padding series."""
        with group.lock:
            if group.candidates is None:
                group.candidates, group.desperate = self._candidates(
                    model=_model_of_path(group.path))
                rm = _ROUTE_METRICS.get()
                version = (_version_of(group.candidates[0])
                           if group.candidates else "unversioned")
                n = group.count
                bucket = cb.default_bucketer().bucket_for(n)
                rm["bucket_occupancy"].observe(n, version=version)
                rm["real_rows"].inc(n, version=version)
                rm["padded_rows"].inc(bucket - n, version=version)
            return group.candidates, group.desperate

    # -- retrieval plane: shard fan-out + global top-k merge ---------------
    def _retrieval_fanout(self, path: str, body) -> tuple[int, dict, dict]:
        """``POST /retrieval/<index>`` with ``{"queries": [[...], ...],
        "k": 10}``: fan the query batch to the workers ADVERTISING each of
        the index's shards (registration ``shards`` lists), score
        per-shard top-k in parallel over the pooled keep-alive
        connections, and merge into global top-k at the front.

        Degradation contract: shards with no reachable holder are SKIPPED
        and named in the ``X-Retrieval-Partial`` response header — a
        partial result with explicit provenance, never a 500 (recall-proxy
        coverage lands in ``synapseml_retrieval_shard_coverage``). A
        worker failure mid-fan-out trips its breaker (same any-failure
        semantics as routed traffic) and retries its shards once on
        another advertising holder before degrading."""
        from ..retrieval.metrics import retrieval_metrics

        index = path.split("?", 1)[0].split("/")[2] if len(
            path.split("/")) >= 3 else ""
        if not index:
            return 404, {"error": "path must be /retrieval/<index>"}, {}
        try:
            req = json.loads(body) if body else {}
        except (ValueError, TypeError):
            return 400, {"error": "body must be JSON"}, {}
        queries = req.get("queries")
        if queries is None and "query" in req:
            queries = [req["query"]]
        if not queries:
            return 400, {"error": "body needs 'queries' or 'query'"}, {}
        k = int(req.get("k") or 10)
        holders = [w for w in self._table()
                   if _hosts_model(w, index) and w.get("shards")]
        if not holders:
            return 503, {"error": f"no workers advertise index "
                                  f"{index!r} shards"}, {}
        # the EXPECTED shard set is the union of advertisements (a downed
        # worker's registration persists until deregister/reap, so its
        # shards stay expected — that is what makes the result honestly
        # partial instead of silently narrower)
        expected = sorted({s for w in holders for s in w["shards"]})
        avail = [w for w in holders
                 if self._breaker((w.get("host"), w.get("port"))).available()]
        plan: dict[tuple, list[str]] = {}
        by_key = {}
        missing = []
        for shard in expected:
            cands = [w for w in avail if shard in w["shards"]]
            if not cands:
                missing.append(shard)
                continue
            w = min(cands, key=lambda c: len(
                plan.get((c.get("host"), c.get("port")), ())))
            key = (w.get("host"), w.get("port"))
            plan.setdefault(key, []).append(shard)
            by_key[key] = w
        t0 = time.perf_counter()
        merged: list[list] = [[] for _ in queries]
        scored: list[str] = []
        lock = threading.Lock()

        def _ask(key, shard_names) -> list[str]:
            """One worker's sub-query; returns the shards it FAILED."""
            breaker = self._breaker(key)
            payload = json.dumps({"queries": queries, "k": k,
                                  "shards": shard_names}).encode()
            try:
                status, raw = _pooled_request(
                    self._pool, key, "POST", f"/m/{index}", payload,
                    {"Content-Type": "application/json"})
                if status != 200:
                    raise ConnectionError(f"worker {key} -> {status}")
                reply = json.loads(raw)
                matches = reply["matches"]
            except Exception:  # noqa: BLE001 — any failure = these shards
                breaker.record_failure()
                return list(shard_names)
            breaker.record_success()
            with lock:
                scored.extend(shard_names)
                for i, row in enumerate(matches):
                    merged[i].extend(row)
            return []

        def _fan(assignments) -> list[str]:
            failed: list[list[str]] = [[] for _ in assignments]

            def run(i, key, names):
                failed[i] = _ask(key, names)

            threads = [threading.Thread(target=run, args=(i, key, names))
                       for i, (key, names) in enumerate(assignments)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return [s for f in failed for s in f]

        lost = _fan(list(plan.items()))
        if lost:
            # one failover round: reassign a failed worker's shards to any
            # OTHER still-available advertising holder
            retry: dict[tuple, list[str]] = {}
            still = []
            for shard in lost:
                cands = [w for w in holders
                         if shard in w["shards"]
                         and self._breaker((w.get("host"),
                                            w.get("port"))).available()]
                if not cands:
                    still.append(shard)
                    continue
                w = min(cands, key=lambda c: len(
                    retry.get((c.get("host"), c.get("port")), ())))
                retry.setdefault((w.get("host"), w.get("port")),
                                 []).append(shard)
            still += _fan(list(retry.items()))
            missing += still
        for i, row in enumerate(merged):
            row.sort(key=lambda m: (m.get("distance", 0.0), m.get("id", 0)))
            merged[i] = row[:k]
        missing = sorted(set(missing))
        m = retrieval_metrics()
        m["merge_ms"].observe((time.perf_counter() - t0) * 1000.0,
                              index=index)
        m["coverage"].observe(
            len(set(scored)) / max(len(expected), 1), index=index)
        hdrs = {}
        if missing:
            m["partial"].inc(index=index)
            hdrs["X-Retrieval-Partial"] = ",".join(missing)
        reply = {"matches": merged, "k": k, "shards": sorted(set(scored)),
                 "missing": missing}
        return 200, reply, hdrs

    # -- deployment plane: canary splits, shadow traffic, version stats ----
    def set_traffic_split(self, split: dict[str, float] | None) -> None:
        """Weighted canary split (version -> weight), e.g. ``{"v1": 0.95,
        "v2": 0.05}``. Weights are normalized; ``None`` restores plain
        round-robin."""
        if split:
            total = sum(float(v) for v in split.values())
            if total <= 0:
                raise ValueError(f"split weights must sum > 0: {split}")
            split = {str(k): float(v) / total for k, v in split.items()}
        else:
            split = None
        with self._deploy_lock:
            self._split = split

    def traffic_split(self) -> dict[str, float] | None:
        with self._deploy_lock:
            return dict(self._split) if self._split else None

    def set_shadow(self, version: str | None,
                   fraction: float = 1.0) -> None:
        """Duplicate ``fraction`` of successfully-served requests to a
        worker of ``version``, discarding the response and recording
        latency/error deltas (``synapseml_route_shadow_*``). ``None``
        disables shadowing."""
        with self._deploy_lock:
            self._shadow = (None if version is None
                            else (str(version), float(fraction)))

    def shadow(self) -> dict | None:
        with self._deploy_lock:
            if self._shadow is None:
                return None
            return {"version": self._shadow[0],
                    "fraction": self._shadow[1]}

    def clear_shadow(self) -> None:
        self.set_shadow(None)

    def version_stats(self) -> dict[str, dict]:
        """Monotonic per-version outcome counters + latency percentiles
        (the rollback controller's input; also exported on ``/stats``)."""
        with self._deploy_lock:
            return {v: s.snapshot()
                    for v, s in self._version_stats.items()}

    def _draw_version(self) -> str | None:
        with self._deploy_lock:
            if not self._split:
                return None
            split = dict(self._split)
            r = self._split_rng.random()
        acc = 0.0
        chosen = None
        for version, weight in split.items():
            acc += weight
            chosen = version
            if r < acc:
                break
        return chosen

    # -- fleet plane: admission control + per-priority accounting ----------
    def set_request_logger(self, logger) -> None:
        """Attach/detach (None) a ``continual.RequestLogger``: every
        forwarded request/response pair is offered to it post-reply."""
        self._request_logger = logger

    def request_logger(self):
        return self._request_logger

    def set_admission(self, controller) -> None:
        """Install/replace/clear (``None``) the admission controller
        (:class:`~synapseml_torch.fleet.admission.AdmissionController`)
        consulted before every routed request."""
        self._admission = controller

    def admission(self):
        return self._admission

    # per-label stats entries are created on demand and never evicted, and
    # the /m/<model> label is CLIENT-controlled — without a cap, a scanner
    # spraying random model paths would grow _version_stats (and /stats
    # output) forever on a long-lived front
    _MAX_TRACKED_LABELS = 512

    def _stats_for(self, label: str, trusted: bool = False) -> _VersionStats:
        """Get-or-create a label's stats. ``trusted`` labels (worker
        registrations' VERSION labels — server-side data the canary
        rollback controller keys on) always get their own entry; untrusted
        labels (client-derived /m/<model> path segments) overflow into
        ``"other"`` past the cap, so a path scanner can fill the cap
        without ever blinding ``version_stats()[canary]``."""
        stats = self._version_stats.get(label)
        if stats is None:
            if not trusted \
                    and len(self._version_stats) >= self._MAX_TRACKED_LABELS \
                    and "other" != label:
                return self._stats_for("other")
            stats = self._version_stats[label] = _VersionStats()
        return stats

    def _record_shed(self, label: str, priority: str) -> None:
        with self._deploy_lock:
            stats = self._stats_for(label)
            stats.shed[priority] = stats.shed.get(priority, 0) + 1

    def _record_inflight(self, label: str, priority: str,
                         delta: int) -> None:
        with self._deploy_lock:
            stats = self._stats_for(label)
            stats.inflight[priority] = max(
                stats.inflight.get(priority, 0) + delta, 0)

    def _observe_admission(self, model: str | None, latency_ms: float,
                           ok: bool) -> None:
        if self._admission is not None:
            self._admission.observe(model or "default", latency_ms, ok=ok)

    def _record_version(self, version: str, ok: bool,
                        latency_ms: float | None = None,
                        shadow: bool = False) -> None:
        with self._deploy_lock:
            stats = self._stats_for(version, trusted=True)
            if shadow:
                if ok:
                    stats.shadow_ok += 1
                else:
                    stats.shadow_err += 1
            elif ok:
                stats.ok += 1
            else:
                stats.err += 1
            if latency_ms is not None and not shadow:
                stats.latencies_ms.append(latency_ms)

    def _maybe_shadow(self, method: str, path: str, body, headers: dict,
                      primary_version: str, primary_ms: float) -> None:
        """Fire-and-forget duplicate to the shadow version (post-reply, so
        the primary response is never delayed). Bounded by the in-flight
        semaphore — saturation drops the duplicate, never queues it."""
        with self._deploy_lock:
            shadow = self._shadow
        if shadow is None:
            return
        version, fraction = shadow
        if version == primary_version:
            return
        if fraction < 1.0 and self._split_rng.random() >= fraction:
            return
        targets = [w for w in self._table() if _version_of(w) == version]
        if not targets or not self._shadow_sem.acquire(blocking=False):
            return
        target = targets[self._rr % len(targets)]
        key = (target.get("host"), target.get("port"))
        rm = _ROUTE_METRICS.get()
        hdrs = {k: v for k, v in headers.items()
                if k.lower() != "traceparent"}

        def run():
            t0 = time.perf_counter()
            try:
                status, _payload = _pooled_request(self._pool, key, method,
                                                   path, body, hdrs)
            except (http.client.HTTPException, OSError):
                self._pool.clear(key)
                self._record_version(version, ok=False, shadow=True)
                rm["shadow_requests"].inc(version=version, status="error")
            else:
                ms = (time.perf_counter() - t0) * 1e3
                # a 5xx reply is a shadow FAILURE (the primary path counts
                # status>=500 as err too) — a canary that errors under
                # shadow must not look healthy to the rollout decision
                ok = status < 500
                self._record_version(version, ok=ok, shadow=True)
                rm["shadow_requests"].inc(
                    version=version,
                    status="ok" if ok else f"{status // 100}xx")
                rm["shadow_delta_ms"].observe(ms - primary_ms,
                                              version=version)
            finally:
                self._shadow_sem.release()

        threading.Thread(target=run, daemon=True).start()

    # -- survivable-LLM plane: journaled streams, migration, hedging -------
    def _admin_migrate(self, body: bytes) -> tuple[int, dict]:
        """Drain-handoff mailbox: a draining worker POSTs ``{"key":
        <journal key>, "snapshot": <exported sequence>}`` here; the relay
        loop for that key picks the snapshot up when the worker's
        ``__migrated__`` marker arrives and resubmits it to a healthy
        worker. A non-2xx tells the worker the handoff failed — it
        re-imports the snapshot locally instead of dropping the request."""
        if self._journal is None:
            return 404, {"error": "journal disabled on this front"}
        try:
            payload = json.loads(body or b"{}")
            key = payload["key"]
            snap = payload["snapshot"]
            if not isinstance(key, str) or not isinstance(snap, dict):
                raise ValueError("key must be a string, snapshot an object")
        except (ValueError, KeyError, TypeError) as e:
            return 400, {"error": str(e)}
        entry = self._journal.get(key)
        if entry is None or entry.done:
            return 404, {"error": f"no live journal entry for {key!r}"}
        with entry.lock:
            entry.mailbox = snap
        return 200, {"ok": True}

    def _journal_route(self, handler, body, rm, model) -> bool:
        """Journaled relay for generation requests; False = not a
        generation body, fall through to plain forwarding."""
        try:
            payload = json.loads(body or b"null")
        except ValueError:
            return False
        if not isinstance(payload, dict) or \
                ("prompt" not in payload and "input_ids" not in payload):
            return False
        jm = _JOURNAL_METRICS.get()
        # idempotency key: client-supplied (retry-safe) or generated
        key = handler.headers.get("X-Request-Key") or uuid.uuid4().hex
        digest = hashlib.sha256(body or b"").hexdigest()
        deadline = None
        dl = handler.headers.get("X-Deadline-Ms")
        if dl:
            try:
                deadline = time.monotonic() + float(dl) / 1e3
            except ValueError:
                pass
        entry, verdict = self._journal.admit(
            key, digest, payload, bool(payload.get("stream")), deadline)
        if verdict == "replay":
            jm["replays"].inc()
            res = entry.result if entry.result is not None \
                else {"error": "no terminal result recorded"}
            handler._reply(entry.status, json.dumps(res).encode(),
                           {"Content-Type": "application/json",
                            "X-Journal-Replay": "1"})
            return True
        if verdict == "conflict":
            handler._reply(409, json.dumps(
                {"error": "request key already in flight",
                 "key": key}).encode(),
                {"Content-Type": "application/json"})
            return True
        entry.inflight = True
        try:
            self._journal_run(handler, entry, rm, model)
        finally:
            entry.inflight = False
        return True

    def _journal_run(self, handler, entry, rm, model) -> None:
        """Attempt loop for one journaled generation: pick a worker,
        relay its stream, and on failure/migration resubmit until the
        terminal record lands or the attempt budget runs out."""
        writer = _StreamWriter(handler, entry)
        hdrs = {k: v for k, v in handler.headers.items()
                if k.lower() not in ("host", "connection", "traceparent",
                                     "content-length", "x-request-key",
                                     "x-deadline-ms")}
        obs.get_tracer().inject(hdrs)
        sig = _prefix_sig(entry.body) if self.route_by_prefix else None
        attempts = 0
        attempt_seq = 0
        tried: set[str] = set()
        attempt_log: list[str] = []
        while attempts < self._max_stream_attempts:
            if entry.deadline is not None \
                    and time.monotonic() >= entry.deadline:
                self._journal_terminal(handler, writer, entry, {
                    "error": "deadline exceeded", "done": True,
                    "finish_reason": "deadline"}, status=504)
                return
            candidates, _ = self._candidates(model=model, prefix_sig=sig)
            # don't hand the resubmit straight back to the endpoint that
            # just failed — unless it is the only one left
            fresh = [w for w in candidates
                     if f"{w.get('host')}:{w.get('port')}" not in tried]
            pick_from = fresh or candidates
            if not pick_from:
                break
            attempts += 1
            w = pick_from[0]
            tried.add(f"{w.get('host')}:{w.get('port')}")
            outcome = self._run_hedged(handler.path, w, pick_from[1:],
                                       entry, writer, hdrs, attempt_seq)
            attempt_seq += 2  # primary + potential hedge ids
            tag = outcome[0]
            attempt_log.append(
                f"{w.get('host')}:{w.get('port')}={':'.join(str(p) for p in outcome)}")
            if tag == "done":
                self._journal_finish(handler, writer, entry)
                return
            if tag == "migrated":
                # the worker posts the snapshot to /admin/migrate BEFORE
                # the marker, so the mailbox is nearly always filled
                # already; the grace wait covers reordering
                wait_until = time.monotonic() + 5.0
                while time.monotonic() < wait_until:
                    with entry.lock:
                        if entry.mailbox is not None:
                            break
                    time.sleep(0.01)
                # the drained worker's attempt has returned (it produced
                # the marker): release arbitration, or the import attempt's
                # chunks would all be rejected as hedge losers
                with entry.lock:
                    entry.winner = None
                # the drained worker stays in `tried`: it self-rejects new
                # work with its drain 503 anyway, so prefer the others
                continue
            if tag == "status":
                _, status, payload = outcome
                try:
                    rec = json.loads(payload or b"null")
                except ValueError:
                    rec = {"error": payload.decode("utf-8", "replace")}
                if not isinstance(rec, dict):
                    rec = {"result": rec}
                rec.setdefault("done", True)
                self._journal_terminal(handler, writer, entry, rec, status)
                return
            if tag == "client_gone":
                with entry.lock:
                    entry.done = True
                    entry.result = {"error": "client disconnected",
                                    "done": True}
                return
            # 'failed' / 'draining': release arbitration so the next
            # attempt may claim the stream, then rotate on
            with entry.lock:
                entry.winner = None
            if tag == "failed":
                resilience_measures("distributed_serving").count("retry")
                rm["retries"].inc()
        self._journal_terminal(handler, writer, entry, {
            "error": "no worker could complete the generation",
            "attempts": attempt_log, "done": True}, status=503)

    def _run_hedged(self, path, primary, alternates, entry, writer, hdrs,
                    base_id):
        """One attempt, hedged: the primary streams in a thread; if no
        first chunk lands within ``hedge_after_s`` (stuck prefill) and an
        alternate worker exists, a second attempt races it — the first to
        deliver a chunk wins the client stream, the loser is closed."""
        outq: "queue.Queue" = queue.Queue()
        first_evt = threading.Event()

        def run(w, aid, evt):
            out = self._stream_attempt(path, w, entry, writer, aid, hdrs,
                                       evt)
            if evt is not None:
                evt.set()  # a fast failure must not stall the hedge gate
            outq.put(out)

        threading.Thread(target=run, args=(primary, base_id, first_evt),
                         daemon=True).start()
        hedged = False
        if self._hedge_after_s is not None and alternates:
            first_evt.wait(self._hedge_after_s)
            if not first_evt.is_set():
                hedged = True
                threading.Thread(
                    target=run, args=(alternates[0], base_id + 1, None),
                    daemon=True).start()
        results = []
        terminal = None
        while len(results) < (2 if hedged else 1):
            out = outq.get()
            results.append(out)
            if out[0] in ("done", "migrated", "status", "client_gone"):
                terminal = out
                break
        if hedged:
            with entry.lock:
                win = entry.winner
            _JOURNAL_METRICS.get()["hedges"].inc(
                outcome="won" if win == base_id + 1 else "lost")
        if terminal is not None:
            return terminal
        for out in results:
            if out[0] == "failed":
                return out
        return results[0]

    def _stream_attempt(self, path, w, entry, writer, attempt_id, hdrs,
                        first_evt):
        """Stream one worker's attempt at a journaled generation, relaying
        chunks through ``writer``. Returns ('done',) | ('migrated',) |
        ('draining',) | ('status', code, payload) | ('failed', err) |
        ('lost',) | ('client_gone',)."""
        key = (w.get("host"), w.get("port"))
        endpoint = f"{key[0]}:{key[1]}"
        breaker = self._breaker(key)
        rm = _ROUTE_METRICS.get()
        jm = _JOURNAL_METRICS.get()
        with entry.lock:
            snap = entry.mailbox
            entry.mailbox = None
            emitted = list(entry.emitted_ids)
            uid = entry.uid
        if snap is not None:
            # migrated KV pages: splice the sequence in wholesale
            body_obj = {"__import__": snap}
            jm["resubmits"].inc(mode="import")
        elif emitted or uid is not None:
            # crash path: deterministic re-prefill over prompt + relayed
            # tokens, keeping the origin uid so sampling stays identical
            body_obj = {"__resume__": {"body": entry.body,
                                       "emitted_ids": emitted,
                                       "uid": uid}}
            jm["resubmits"].inc(mode="resume")
        else:
            body_obj = dict(entry.body)
            body_obj["stream"] = True  # the front owns client framing
        send_hdrs = dict(hdrs)
        send_hdrs["X-Request-Key"] = entry.key
        if entry.deadline is not None:
            left_ms = (entry.deadline - time.monotonic()) * 1e3
            if left_ms <= 0:
                return ("failed", "deadline expired")
            send_hdrs["X-Deadline-Ms"] = str(max(int(left_ms), 1))
        conn = None
        accepted = False  # worker took the body: the snapshot is spent
        try:
            try:
                conn, _fresh = self._pool.get(key)  # fault hook fires here
                conn.request("POST", path,
                             body=json.dumps(body_obj).encode(),
                             headers=send_hdrs)
                resp = conn.getresponse()
            except (http.client.HTTPException, OSError) as e:
                breaker.record_failure()
                self._pool.clear(key)
                rm["worker_failures"].inc(worker=endpoint)
                return ("failed", str(e))
            if resp.status != 200:
                payload = resp.read()
                breaker.record_success()  # it answered: alive
                if resp.status == 503 \
                        and payload == b'{"error": "worker draining"}':
                    return ("draining",)
                return ("status", resp.status, payload)
            accepted = True
            breaker.record_success()
            with entry.lock:
                entry.worker = endpoint
            while True:
                try:
                    line = resp.readline()
                except (http.client.HTTPException, OSError,
                        ValueError) as e:
                    breaker.record_failure()
                    self._pool.clear(key)
                    rm["worker_failures"].inc(worker=endpoint)
                    return ("failed", f"stream broke: {e}")
                if not line:
                    # ended without a terminal record: the worker died
                    # between chunks
                    breaker.record_failure()
                    rm["worker_failures"].inc(worker=endpoint)
                    return ("failed", "stream ended without terminal")
                line = line.strip()
                if not line:
                    continue
                try:
                    chunk = json.loads(line)
                except ValueError:
                    continue
                if first_evt is not None:
                    first_evt.set()
                if isinstance(chunk, dict) and chunk.get("__migrated__"):
                    return ("migrated",)
                if isinstance(chunk, dict) and "error" in chunk \
                        and "token" not in chunk:
                    # worker-side terminal error (hot swap, engine
                    # failure): resubmittable — the journal can rebuild
                    # the sequence elsewhere
                    return ("failed", str(chunk.get("error")))
                try:
                    verdict = writer.deliver(chunk, attempt_id)
                except _ClientGone:
                    return ("client_gone",)
                if verdict == "lost":
                    return ("lost",)
                if isinstance(chunk, dict) and chunk.get("done"):
                    return ("done",)
        finally:
            if snap is not None and not accepted:
                # the worker never took the migrated snapshot (refused /
                # unreachable): put it back so the NEXT attempt can still
                # splice the KV pages instead of re-prefilling
                with entry.lock:
                    if entry.mailbox is None:
                        entry.mailbox = snap
            if conn is not None:
                conn.close()

    def _journal_finish(self, handler, writer, entry) -> None:
        with entry.lock:
            res = entry.result if entry.result is not None else {}
            if isinstance(res, dict) \
                    and res.get("finish_reason") == "deadline":
                entry.status = 504
            status = entry.status
        if entry.client_stream:
            writer.finish_stream()  # terminal chunk already relayed
        else:
            handler._reply(status, json.dumps(res).encode(),
                           {"Content-Type": "application/json"})

    def _journal_terminal(self, handler, writer, entry, record: dict,
                          status: int) -> None:
        """Front-originated terminal (deadline, attempt exhaustion): the
        client ALWAYS gets a terminal reply — an error chunk + end on a
        begun stream, a plain status reply otherwise."""
        with entry.lock:
            entry.done = True
            entry.result = record
            entry.status = status
        if writer.began:
            try:
                writer._write(record)
            except OSError:
                pass
            writer.finish_stream()
        else:
            handler._reply(status, json.dumps(record).encode(),
                           {"Content-Type": "application/json"})

    def _admin_split(self, method: str, body: bytes) -> tuple[int, dict]:
        """``GET /admin/split`` reads, ``POST /admin/split`` applies
        ``{"split": {...}|null, "shadow": {"version": v, "fraction": f}
        |null}`` — the deployment plane's HTTP surface on the front."""
        if method == "GET":
            return 200, {"split": self.traffic_split(),
                         "shadow": self.shadow()}
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            if "split" in payload:
                self.set_traffic_split(payload["split"])
            if "shadow" in payload:
                sh = payload["shadow"]
                if sh is None:
                    self.clear_shadow()
                else:
                    self.set_shadow(sh["version"],
                                    float(sh.get("fraction", 1.0)))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return 400, {"error": str(e)}
        return 200, {"ok": True, "split": self.traffic_split(),
                     "shadow": self.shadow()}

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._pool.close()


class RoutingClient:
    """Serve-where-it-lands client: fetches the routing table from a front's
    ``/routes`` (or takes a worker list), then talks to workers DIRECTLY over
    its own persistent connections, round-robin — zero proxy hops, the
    client-side analog of Spark clients hitting whichever executor serves
    them (``DistributedHTTPSource.scala:88-203``). Failing workers trip a
    per-worker circuit breaker (skipped until the ``resurrect_after_s``
    half-open probe) and the table is refreshed; when every breaker is open
    the least-recently-failed worker is tried anyway. Thread-safe.
    """

    def __init__(self, front_address: str | None = None,
                 workers: list[dict] | None = None, timeout_s: float = 10.0,
                 resurrect_after_s: float = 2.0):
        if front_address is None and workers is None:
            raise ValueError("RoutingClient needs front_address or workers")
        self._front = front_address
        self._workers = list(workers or [])
        self._pool = _ConnPool(timeout_s)
        self._rr = 0
        self._lock = threading.Lock()
        self._timeout_s = timeout_s
        self._resurrect_after_s = resurrect_after_s
        self._breakers: dict[tuple, CircuitBreaker] = {}
        _register_breaker_gauge(self, plane="client")
        if self._front is not None:
            self.refresh()

    def _breaker(self, key: tuple) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = CircuitBreaker(
                    failure_rate_threshold=0.0, window=1, min_samples=1,
                    probe_interval_s=self._resurrect_after_s,
                    measures=resilience_measures("distributed_serving"),
                    name=f"client {key[0]}:{key[1]}")
                self._breakers[key] = breaker
            return breaker

    def breaker_states(self) -> dict:
        """(host:port -> breaker state) snapshot, mirroring the front's."""
        with self._lock:
            return {f"{h}:{p}": br.state
                    for (h, p), br in self._breakers.items()}

    def refresh(self) -> list[dict]:
        if self._front is not None:
            with urllib.request.urlopen(self._front + "/routes",
                                        timeout=self._timeout_s) as r:
                table = json.loads(r.read())
            live_keys = {(w.get("host"), w.get("port")) for w in table}
            with self._lock:
                self._workers = table
                # drop breakers for workers no longer in the table (respawn
                # churn would otherwise grow the map forever)
                self._breakers = {k: b for k, b in self._breakers.items()
                                  if k in live_keys}
        return list(self._workers)

    def request(self, path: str, body: bytes | None = None,
                method: str | None = None, headers: dict | None = None):
        """(status, payload) from the next worker in rotation; a worker
        failure rotates on (with a table refresh) before giving up. Each
        request runs in one ``route.client`` span whose context is injected
        as ``traceparent`` so the worker's serving span joins the trace."""
        method = method or ("POST" if body is not None else "GET")
        tracer = obs.get_tracer()
        with tracer.span("route.client", {"path": path, "method": method}):
            headers = dict(headers or {})
            tracer.inject(headers)
            return self._request_routed(path, body, method, headers)

    def _request_routed(self, path: str, body, method: str, headers: dict):
        rm = _ROUTE_METRICS.get()
        with self._lock:
            table = list(self._workers)
            self._rr += 1
            rot = self._rr
        if not table:
            raise ConnectionError("no workers in the routing table")
        last_err, tried = None, 0
        for i in range(len(table)):
            w = table[(rot + i) % len(table)]
            key = (w.get("host"), w.get("port"))
            breaker = self._breaker(key)
            if not breaker.allow():
                continue  # breaker open: skip until its half-open probe
            if tried:
                resilience_measures("distributed_serving").count("retry")
            tried += 1
            t0 = time.perf_counter()
            try:
                result = _pooled_request(self._pool, key, method, path, body,
                                         headers)
                breaker.record_success()
                rm["request_ms"].observe((time.perf_counter() - t0) * 1e3,
                                         worker=f"{key[0]}:{key[1]}")
                return result
            except (http.client.HTTPException, OSError) as e:
                breaker.record_failure()
                self._pool.clear(key)
                last_err = e
            if self._front is not None:
                try:
                    table = self.refresh() or table
                except (urllib.error.URLError, OSError):
                    pass
        if tried == 0:
            # every breaker open: desperation-probe the stalest failure (the
            # client degrades to retrying, never to a permanent error)
            w = min(table, key=lambda w: self._breaker(
                (w.get("host"), w.get("port"))).last_failure_at or 0.0)
            key = (w.get("host"), w.get("port"))
            breaker = self._breaker(key)
            try:
                result = _pooled_request(self._pool, key, method, path, body,
                                         headers)
                breaker.record_success()
                return result
            except (http.client.HTTPException, OSError) as e:
                breaker.record_failure()
                self._pool.clear(key)
                last_err = e
        raise ConnectionError(f"all {len(table)} workers failed: {last_err}")

    def close(self) -> None:
        self._pool.close()


def worker_main(pipeline_path: str, registry_address: str,
                batch_interval_ms: int = 0,
                version: str | None = None) -> None:
    """Worker process entry: load the pickled pipeline, serve it, register,
    then park forever (the per-executor server loop). A hot swap
    (``POST /admin/load``) re-registers the worker with its NEW version so
    the front's canary routing and per-version metrics follow the swap.
    Every stage's ``device`` is resolved before the worker serves or
    registers: one that names the card on a host without one raises."""
    from .serving import serve_pipeline

    with open(pipeline_path, "rb") as f:
        pipeline = pickle.load(f)
    _check_devices(pipeline)
    server = serve_pipeline(pipeline, batch_interval_ms=batch_interval_ms,
                            version=version)

    def register(*_swap_args) -> dict:
        info = {"host": server.host, "port": server.port,
                "pid": os.getpid(),
                "version": server.pipeline_holder.version}
        # fleet-swap observability: whether this worker's last hot swap
        # rode the AOT executable path (registry/aot.py) — the front's
        # worker listing shows at a glance if a rollout was compile-bound
        report = getattr(server, "last_swap_report", None)
        if report:
            info["aot"] = report.get("mode")
        urllib.request.urlopen(urllib.request.Request(
            registry_address, data=json.dumps(info).encode(), method="POST",
            headers={"Content-Type": "application/json"}), timeout=30).read()
        return info

    server.pipeline_holder.subscribe(register)
    info = register()

    def on_drained(_report) -> None:
        # graceful removal (fleet plane): deregister BEFORE exiting so the
        # front's routing table reflects the drain, then leave — the
        # supervisor (if any) sees a clean exit, not a crash to respawn
        deregister_worker(registry_address, info)
        os._exit(0)

    server.on_drained = on_drained
    print(f"worker ready {info}", flush=True)
    while True:  # killed by the parent, or exits via /admin/drain
        time.sleep(1.0)


def llm_worker_main(model_name: str, registry_address: str,
                    max_new_tokens: int = 64, engine: str = "paged",
                    warmup: bool = True, device: str = "cuda",
                    stage_params: dict | None = None) -> None:
    """LLM decode-worker process entry: build the named causal LM (an
    architecture preset or a local checkpoint directory) on ``device``,
    serve it with the token scheduler (``serve_llm``), register with the
    driver registry, then park. ``stage_params`` sets further Params of the
    ``HuggingFaceCausalLM`` stage (``tokenizer`` for a directory without
    tokenizer files, ``decode_slots``, ``kv_blocks``...). The
    survivable-serving chaos tests SIGKILL these processes mid-decode; a
    drain (``/admin/drain`` with ``migrate_to``) deregisters and exits
    cleanly instead."""
    from ..hf import HuggingFaceCausalLM
    from .serving import serve_llm

    lm = HuggingFaceCausalLM(model_name=model_name,
                             max_new_tokens=max_new_tokens, engine=engine,
                             device=device, **(stage_params or {}))
    _check_devices(lm)
    server = serve_llm(lm, warmup=warmup)
    info = {"host": server.host, "port": server.port, "pid": os.getpid()}
    urllib.request.urlopen(urllib.request.Request(
        registry_address, data=json.dumps(info).encode(), method="POST",
        headers={"Content-Type": "application/json"}), timeout=30).read()

    def on_drained(_report) -> None:
        deregister_worker(registry_address, info)
        os._exit(0)

    server.on_drained = on_drained
    print(f"llm worker ready {info}", flush=True)
    while True:  # killed by the parent/chaos, or exits via /admin/drain
        time.sleep(1.0)


def _check_devices(pipeline) -> None:
    """Resolve the ``device`` of every stage of ``pipeline``: a stage that
    names the card raises on a host without one (the worker must not come
    up and serve on the CPU)."""
    from ..core.device import resolve_device

    for stage in cb.stage_tree(pipeline):
        has_param = getattr(stage, "has_param", None)
        if callable(has_param) and has_param("device"):
            resolve_device(f"worker: {type(stage).__name__}",
                           stage.get("device"))


class DistributedServing:
    """Handle owning the registry, worker processes, and routing front.

    A supervisor thread respawns any worker process that dies (the reference
    relies on Spark re-launching failed executors; here the driver handle does
    it): the replacement registers itself with the registry on startup and the
    registry-backed front routes to it immediately."""

    def __init__(self, front: RoutingFront, registry: WorkerRegistry,
                 procs: list, tmp_file: str, spawn=None,
                 supervise_interval_s: float = 0.25):
        self.front = front
        self.registry = registry
        self.procs = procs
        self._tmp_file = tmp_file
        self._spawn = spawn
        self._stopping = threading.Event()
        self._supervisor = None
        if spawn is not None:
            self._supervisor = threading.Thread(
                target=self._supervise, args=(supervise_interval_s,),
                daemon=True)
            self._supervisor.start()

    def _supervise(self, interval_s: float) -> None:
        # per-slot respawn backoff: a worker that keeps dying young (crash on
        # startup: bad pickle, OOM on load) is respawned at a decaying rate
        # (doubling delay, capped) instead of ~4 forks/sec forever; a spawn
        # failure itself never kills the supervisor thread.
        n = len(self.procs)
        next_try, delay, spawned = [0.0] * n, [interval_s] * n, [0.0] * n
        while not self._stopping.wait(interval_s):
            now = time.monotonic()
            for i, p in enumerate(self.procs):
                if p.poll() is None:
                    if now - spawned[i] > 10.0:
                        delay[i] = interval_s  # survived long enough: reset
                    continue
                if self._stopping.is_set() or now < next_try[i]:
                    continue
                self.registry.remove_pid(p.pid)
                try:
                    self.procs[i] = self._spawn()
                    spawned[i] = now
                except OSError as e:
                    print(f"# worker respawn failed (slot {i}): {e}",
                          file=sys.stderr, flush=True)
                delay[i] = min(delay[i] * 2, 10.0)
                next_try[i] = now + delay[i]

    @property
    def address(self) -> str:
        return self.front.address

    def stop(self) -> None:
        self._stopping.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        self.front.close()
        self.registry.close()
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        try:
            os.unlink(self._tmp_file)
        except OSError:
            pass


def serve_pipeline_distributed(pipeline, num_workers: int = 2,
                               batch_interval_ms: int = 0,
                               startup_timeout_s: float = 90.0,
                               version: str | None = None,
                               coalesce_window_ms: float = 0.0) -> DistributedServing:
    """Serve a (picklable) Transformer across ``num_workers`` OS processes
    behind one routed public port — the DistributedHTTPSource analog.
    ``version`` labels the initial pipeline for the deployment plane
    (canary splits + per-version metrics; see ``registry/deploy.py``).
    ``coalesce_window_ms`` > 0 groups same-path requests at the front so
    they reach one worker as a bucket-sized batch (continuous batching
    across the fleet) — padding-waste and occupancy land in the metrics
    registry per version. Coalescing requires micro-batch workers
    (``batch_interval_ms`` > 0): funneling a group at a continuous worker
    that drains one row per loop would add the window's latency and
    serialize the group on one process for zero batching gain."""
    if coalesce_window_ms > 0 and batch_interval_ms == 0:
        raise ValueError(
            "coalesce_window_ms requires micro-batch workers: set "
            "batch_interval_ms > 0 so the chosen worker drains the "
            "coalesced group as one batch (continuous workers drain one "
            "row per loop — the group would serialize for no gain)")
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".pipeline.pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(pipeline, f)

    registry = WorkerRegistry()
    code = ("from synapseml_torch.io.distributed_serving import worker_main; "
            f"worker_main({path!r}, {registry.address + '/register'!r}, "
            f"{batch_interval_ms}, version={version!r})")
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [repo_root]
    # unpickling user-defined Transformer classes in the worker needs their
    # defining modules importable: the import root of the pipeline's class
    # and of each nested stage's (the directory a module's dotted name
    # resolves from; a package's own directory would let its files shadow
    # the standard library's, e.g. core/logging.py)
    for stage in cb.stage_tree(pipeline):
        root = _import_root(type(stage).__module__)
        if root is not None and root not in paths:
            paths.append(root)
    env["PYTHONPATH"] = os.pathsep.join(paths + [env.get("PYTHONPATH", "")])

    def spawn():
        return subprocess.Popen([sys.executable, "-c", code], env=env)

    procs = [spawn() for _ in range(num_workers)]
    try:
        registry.wait_for(num_workers, timeout_s=startup_timeout_s)
    except TimeoutError:
        for p in procs:
            p.terminate()
        registry.close()
        raise
    front = RoutingFront(registry=registry,
                         coalesce_window_ms=coalesce_window_ms)
    return DistributedServing(front, registry, procs, path, spawn=spawn)


def _import_root(module_name: str) -> str | None:
    """The ``sys.path`` entry ``module_name`` imports from (None for a
    module without a file, such as ``__main__`` run with ``-c``)."""
    mod_file = getattr(sys.modules.get(module_name), "__file__", None)
    if not mod_file:
        return None
    root = os.path.dirname(os.path.abspath(mod_file))
    depth = module_name.count(".")
    if os.path.basename(mod_file).startswith("__init__."):
        depth += 1
    for _ in range(depth):
        root = os.path.dirname(root)
    return root


def collect_distributed_trace(front_address: str,
                              timeout_s: float = 10.0) -> list[dict]:
    """Stitch one multi-process trace: the front process's spans
    (``GET /trace`` served by the front itself) + every live worker's spans
    (``GET /trace`` on each endpoint from ``/routes``). Returns a flat list
    of span dicts — feed it to
    :func:`~synapseml_torch.core.observability.chrome_trace_events` /
    ``export_chrome_trace`` for one Perfetto-loadable timeline."""
    spans: list[dict] = []
    with urllib.request.urlopen(front_address + "/trace",
                                timeout=timeout_s) as r:
        spans.extend(json.loads(r.read()))
    with urllib.request.urlopen(front_address + "/routes",
                                timeout=timeout_s) as r:
        table = json.loads(r.read())
    for w in table:
        url = f"http://{w.get('host')}:{w.get('port')}/trace"
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as r:
                spans.extend(json.loads(r.read()))
        except (urllib.error.URLError, OSError):
            continue  # a dead worker's spans are simply missing
    return spans


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
