"""Model serving: HTTP requests in, pipeline transform, replies out.

Counterpart of ``synapseml_tpu/io/serving.py`` (reference Spark Serving's
``HTTPSourceV2``/``HTTPSinkV2``): a threaded stdlib HTTP server parks each
connection on an Event; ``ServingServer.read_batch`` drains the queue into
a DataFrame (micro-batch mode); ``reply_batch`` completes the parked
exchanges by request id. ``serve_pipeline`` wires a Transformer into that
loop, micro-batch with ``batch_interval_ms`` (the continuous-batching
scheduler flushes at ladder rungs) or per request (``interval=0``).
``serve_llm`` runs the token-granular scheduler over the paged decode
engine instead: prefill between decode steps, chunked NDJSON streams,
immediate slot refill, ``X-Deadline-Ms`` expiry, ``client_gone`` reaping,
``__resume__``/``__import__`` continuations, and a drain that hands live
sequences to ``migrate_to`` or re-imports them locally when the handoff
fails.

Every server answers ``GET /metrics`` (Prometheus text), ``GET /trace``
(the spans, each request's under its ``traceparent``), ``GET
/admin/version``, ``GET /admin/stats``, ``POST /admin/drain`` and ``POST
/admin/load``: a hot swap by ``path`` or by ``registry``+``model``+``ref``
that loads side by side, pins autotuned backends, applies the manifest's
sharding, warms the replacement through the serve loop's own batch
preparation (``run_warmup``) and swaps in one assignment; in-flight
batches finish on the old pipeline, whose cached callables are released.
The port records no AOT executables (``registry/aot.py``): a load warms up
by JIT with the body's warmup rows, and a manifest that carries
``aot.entries`` falls back to that warmup (with its recorded rows when the
body brings none) and one structured warning.

Grad mode is thread-local: the serve loops and the warmup disable it in
their own threads with ``torch.no_grad()``. Not ``inference_mode``: the
paged engine's page pool is shared with the stage's ``transform``, and an
inference tensor cannot be written in place outside inference mode.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..core import batching as cb
from ..core import observability as obs
from ..core.dataframe import DataFrame

__all__ = ["ServingServer", "serve_pipeline", "serve_llm",
           "NoDelayHTTPServer", "PipelineHolder", "run_warmup"]

# batch-size histogram rungs: one bucket per pow-2 occupancy up to the
# serve-loop max (NOT latency buckets — these count rows per micro-batch)
_BATCH_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# default /admin/load warmup precompiles ladder rungs up to this many rows;
# an explicit serve_pipeline(bucket_ladder=...) warms its full ladder
_DEFAULT_WARMUP_CAP = 64

# hot-path metric handles, re-resolved only when the registry is replaced
_SERVING_METRICS = obs.HandleCache(lambda reg: {
    "request_ms": reg.histogram(
        "synapseml_serving_request_duration_ms",
        "worker HTTP request latency", ("method",)),
    "requests": reg.counter(
        "synapseml_serving_requests_total",
        "worker HTTP requests by status class", ("method", "status")),
    "queue_wait": reg.histogram(
        "synapseml_serving_queue_wait_ms",
        "request time spent queued before batch pickup").labels(),
    "swaps": reg.counter(
        "synapseml_serving_pipeline_swaps_total",
        "hot pipeline swaps on this worker, by outcome", ("outcome",)),
    "batch_rows": reg.histogram(
        "synapseml_serving_batch_rows",
        "rows per drained serve-loop micro-batch (continuous batching "
        "occupancy)", buckets=_BATCH_ROW_BUCKETS).labels(),
    "expired": reg.counter(
        "synapseml_serving_expired_requests_total",
        "queued requests dropped because their reply deadline passed "
        "before batch pickup").labels(),
    "drains": reg.counter(
        "synapseml_serving_drains_total",
        "graceful worker drains, by outcome", ("outcome",)),
    "migrations": reg.counter(
        "synapseml_llm_migrations_total",
        "live LLM sequence migrations off this worker, by reason "
        "(drain/...) and outcome (ok = peer accepted the KV snapshot, "
        "error = handoff failed and the sequence resumed locally)",
        ("reason", "outcome")),
    "migration_ms": reg.histogram(
        "synapseml_llm_migration_ms",
        "per-sequence live-migration latency: KV export -> peer "
        "acceptance via the front").labels(),
})


class PipelineHolder:
    """The mutable slot the serving loop reads its pipeline from.

    Hot-swap (``POST /admin/load``) loads the replacement side-by-side,
    warms it, then calls :meth:`swap` — one attribute assignment under a
    lock, so in-flight batches finish on the old pipeline and the next
    batch picks up the new one with zero dropped requests. ``subscribe``
    registers ``fn(new_version, old_version)`` callbacks fired after every
    swap (the distributed worker re-registers its new version through
    one); a callback that raises does not undo the swap."""

    def __init__(self, pipeline, version: str | None = None):
        self._lock = threading.Lock()
        self._pipeline = pipeline
        self._version = version
        self._callbacks: list = []

    @property
    def version(self) -> str | None:
        with self._lock:
            return self._version

    @property
    def pipeline(self):
        with self._lock:
            return self._pipeline

    def get(self):
        """(pipeline, version) — one consistent snapshot."""
        with self._lock:
            return self._pipeline, self._version

    def subscribe(self, fn) -> None:
        """``fn(new_version, old_version)`` after every successful swap."""
        self._callbacks.append(fn)

    def swap(self, pipeline, version: str | None = None) -> str | None:
        with self._lock:
            old = self._version
            self._pipeline = pipeline
            self._version = version
        for fn in list(self._callbacks):
            try:
                fn(version, old)
            except Exception:  # noqa: BLE001 - a callback must not undo a swap
                pass
        return old


class NoDelayHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that sets TCP_NODELAY on every accepted socket.
    With HTTP/1.1 keep-alive, Nagle + the peer's delayed ACK turns each
    small-write response into a ~40 ms stall; sub-millisecond serving (the
    reference's claim) requires segments to go out immediately. Enforced
    here at accept time so no Handler class can forget it."""

    def get_request(self):
        sock, addr = super().get_request()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, addr


_STREAM_END = object()  # chunk-queue sentinel: close the chunked response


class _Exchange:
    def __init__(self, request_id: str, method: str, path: str, headers: dict,
                 body: bytes):
        self.request_id = request_id
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.enqueued_at = time.perf_counter()  # queue-wait measurement
        self.reply_event = threading.Event()
        self.reply_body: bytes = b""
        self.reply_status: int = 200
        self.reply_headers: dict = {}
        # token-streaming mode: the scheduler pushes chunks, the parked
        # handler thread writes them out as HTTP/1.1 chunked encoding.
        # The chunk queue is created lazily in stream_begin — the dominant
        # non-streaming path must not pay a Queue (lock + 3 condvars) per
        # request
        self.streaming = False
        self.chunks: "queue.Queue | None" = None
        self._replied = False
        # set by the handler when a stream write hits a dead socket: the
        # token scheduler checks it and aborts the sequence (reason
        # 'client_gone') instead of decoding to max_new into nothing
        self.client_gone = False

    def respond(self, body, status: int = 200, headers: dict | None = None):
        if self._replied:
            return  # first terminal reply wins (drop-path vs handler races)
        self._replied = True
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
            headers = {"Content-Type": "application/json", **(headers or {})}
        elif isinstance(body, str):
            body = body.encode()
        self.reply_body = body or b""
        self.reply_status = status
        self.reply_headers = headers or {}
        self.reply_event.set()

    def stream_begin(self, status: int = 200,
                     headers: dict | None = None) -> None:
        """Switch the parked handler into chunked-streaming mode; chunks
        pushed via :meth:`stream_chunk` flush per token."""
        if self._replied:
            return
        self._replied = True
        self.chunks = queue.Queue()
        self.streaming = True
        self.reply_status = status
        self.reply_headers = headers or {"Content-Type":
                                         "application/x-ndjson"}
        self.reply_event.set()

    def stream_chunk(self, data) -> None:
        if self.chunks is None or self.client_gone:
            return  # stream never began (or the peer socket is dead)
        if isinstance(data, (dict, list)):
            data = (json.dumps(data) + "\n").encode()
        elif isinstance(data, str):
            data = data.encode()
        self.chunks.put(data)

    def stream_end(self) -> None:
        if self.chunks is not None:
            self.chunks.put(_STREAM_END)


def _header(headers: dict, name: str) -> str | None:
    """Case-insensitive header lookup on a plain-dict header map."""
    want = name.lower()
    for k, v in headers.items():
        if str(k).lower() == want:
            return v
    return None


def _post_json(url: str, obj, timeout: float = 10.0) -> bool:
    """Best-effort JSON POST; True iff the peer replied 2xx."""
    import http.client
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname,
                                      parts.port or 80, timeout=timeout)
    try:
        body = json.dumps(obj).encode()
        conn.request("POST", parts.path or "/", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return 200 <= resp.status < 300
    except OSError:
        return False
    finally:
        conn.close()


class ServingServer:
    """(ref ``HTTPSourceV2``/``DistributedHTTPSource``)"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 reply_timeout_s: float = 30.0, max_queue: int = 4096):
        self.reply_timeout_s = reply_timeout_s
        # set by serve_pipeline: the hot-swap slot + the loop's parsing
        # config (the /admin/load warmup must prepare batches EXACTLY like
        # the serve loop does, or warmup success proves nothing)
        self.pipeline_holder: PipelineHolder | None = None
        self._loop_cfg = {"parse_json": True, "input_col": "body"}
        # serve-loop bucket ladder (set by serve_pipeline): the adaptive
        # scheduler's flush rungs. _warmup_buckets is the /admin/load
        # precompile set — the full ladder when explicitly configured, the
        # latency-sensitive small rungs otherwise (a default full-ladder
        # warmup of a heavy model can outlast the deploy plane's load
        # timeout; big batches amortize a compile stall anyway)
        self._bucket_ladder: tuple | None = None
        self._warmup_buckets: tuple = ()
        # the last swap's warmup breakdown (/admin/stats reports it)
        self.last_swap_report: dict | None = None
        # graceful-drain state (fleet plane, POST /admin/drain): a draining
        # worker refuses NEW requests with terminal 503s, finishes the
        # queued backlog, then fires on_drained (worker entrypoints
        # deregister + exit there; in-process launchers stop the server) —
        # a scale-down is now distinguishable from a crash
        self.draining = False
        self.on_drained = None  # fn(report: dict), called once, off-thread
        self._drain_thread: threading.Thread | None = None
        # live-drain handoff (serve_llm): /admin/drain may name a front to
        # migrate active sequences to; drain_barrier (set by the token
        # scheduler) holds the drain waiter open until every live sequence
        # has migrated or finished — streaming exchanges are NOT in
        # _pending, so the settle loop alone would conclude too early
        self.migrate_to: str | None = None
        self.drain_barrier = None  # fn(budget_s), blocks until quiesced
        # handlers between their draining check and their queue insert: the
        # drain waiter must not conclude "empty" while an admission is in
        # flight (guarded by _lock)
        self._admitting = 0
        self.started_at = time.monotonic()
        # set by serve_multi_model: the residency manager /admin/stats reads
        self.residency = None
        # set by serve_llm: engine-level stats (prefix-cache occupancy /
        # hit-rate, speculation acceptance) surface on /admin/stats so the
        # routing front and autoscaler read them without scraping /metrics
        self.llm_stats_fn = None
        # continual plane (continual/logger.py): a RequestLogger attached
        # here records every batched exchange at reply time — sampled,
        # bounded, shed-before-delay, so serving latency never pays for it
        self.request_logger = None
        # bounded: a stalled pipeline sheds load with 503s instead of parking
        # unbounded connections (backpressure the round-1 loop lacked)
        self._queue: "queue.Queue[_Exchange]" = queue.Queue(maxsize=max_queue)
        self._pending: dict[str, _Exchange] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: connections persist across requests — the per-request
            # TCP handshake is most of the loopback round-trip (the
            # reference's JVMSharedServer keeps executor sockets open too);
            # the server sets TCP_NODELAY at accept (NoDelayHTTPServer)
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply_bytes(self, status: int, payload: bytes,
                             content_type: str | None = None) -> None:
                self.send_response(status)
                if content_type:
                    self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                if payload:
                    self.wfile.write(payload)

            def _handle(self, method: str):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if method == "GET" and self.path == "/metrics":
                    payload, ctype = obs.prometheus_exposition()
                    self._reply_bytes(200, payload, ctype)
                    return
                if method == "GET" and self.path == "/trace":
                    payload = json.dumps(
                        obs.get_tracer().spans_as_dicts()).encode()
                    self._reply_bytes(200, payload, "application/json")
                    return
                # deployment-plane admin endpoints (registry/deploy.py):
                # handled here, never queued behind the pipeline
                if method == "GET" and self.path == "/admin/version":
                    self._reply_bytes(
                        200, json.dumps(outer._admin_version()).encode(),
                        "application/json")
                    return
                if method == "GET" and self.path == "/admin/stats":
                    self._reply_bytes(
                        200, json.dumps(outer._admin_stats()).encode(),
                        "application/json")
                    return
                if method == "POST" and self.path == "/admin/load":
                    status, reply = outer._admin_load(body)
                    self._reply_bytes(status, json.dumps(reply).encode(),
                                      "application/json")
                    return
                if method == "POST" and self.path == "/admin/drain":
                    status, reply = outer._admin_drain(body)
                    self._reply_bytes(status, json.dumps(reply).encode(),
                                      "application/json")
                    return
                # one span per served request, stitched to the caller's trace
                # via the W3C traceparent header the RoutingFront injects
                tracer = obs.get_tracer()
                parent = obs.extract_context(self.headers)
                t0 = time.perf_counter()
                status = None  # stays None when _exchange raises -> "error"
                try:
                    with tracer.span("serving.request",
                                     {"path": self.path, "method": method},
                                     parent=parent):
                        status = self._exchange(method, body)
                finally:
                    dur_ms = (time.perf_counter() - t0) * 1e3
                    m = _SERVING_METRICS.get()
                    m["request_ms"].observe(dur_ms, method=method)
                    m["requests"].inc(
                        method=method,
                        status=(f"{status // 100}xx" if status is not None
                                else "error"))

            def _exchange(self, method: str, body: bytes) -> int:
                # the admitting count brackets the draining check and the
                # queue insert, so the drain waiter can never observe an
                # empty queue while this handler is between the two (the
                # accepted-then-abandoned race)
                with outer._lock:
                    outer._admitting += 1
                    draining = outer.draining
                if draining:
                    with outer._lock:
                        outer._admitting -= 1
                    # a draining worker refuses NEW work with a terminal
                    # reply (never a queued request it would then abandon);
                    # Retry-After points clients at the rest of the fleet.
                    # NOTE: the RoutingFront reroutes on an EXACT match of
                    # this payload — change both together.
                    payload = json.dumps(
                        {"error": "worker draining"}).encode()
                    self.send_response(503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Retry-After", "1")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return 503
                ex = _Exchange(uuid.uuid4().hex, method, self.path,
                               dict(self.headers), body)
                with outer._lock:
                    outer._pending[ex.request_id] = ex
                try:
                    outer._queue.put_nowait(ex)
                except queue.Full:
                    with outer._lock:
                        outer._pending.pop(ex.request_id, None)
                        outer._admitting -= 1
                    self.send_response(503)  # shed load under backpressure
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return 503
                with outer._lock:
                    outer._admitting -= 1
                ok = ex.reply_event.wait(outer.reply_timeout_s)
                with outer._lock:
                    outer._pending.pop(ex.request_id, None)
                if not ok:
                    self.send_response(504)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return 504
                if ex.streaming:
                    return self._stream_reply(ex)
                self.send_response(ex.reply_status)
                for k, v in ex.reply_headers.items():
                    if k.lower() != "content-length":  # we set the real one
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(ex.reply_body)))
                self.end_headers()
                self.wfile.write(ex.reply_body)
                return ex.reply_status

            def _stream_reply(self, ex) -> int:
                """Incremental (token-streaming) reply: HTTP/1.1 chunked
                encoding, one flush per pushed chunk. The handler thread
                stays parked on the chunk queue; a scheduler that stops
                feeding it past ``reply_timeout_s`` truncates the stream
                cleanly rather than parking the connection forever."""
                self.send_response(ex.reply_status)
                for k, v in ex.reply_headers.items():
                    if k.lower() not in ("content-length",
                                         "transfer-encoding"):
                        self.send_header(k, v)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    while True:
                        try:
                            chunk = ex.chunks.get(
                                timeout=outer.reply_timeout_s)
                        except queue.Empty:
                            break  # stalled producer: close the stream
                        if chunk is _STREAM_END:
                            break
                        if chunk:
                            self.wfile.write(b"%x\r\n" % len(chunk) + chunk
                                             + b"\r\n")
                            self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # the client hung up mid-stream: flag the exchange so
                    # the scheduler reaps the sequence (pages freed NOW)
                    # rather than decoding the rest into a dead socket
                    ex.client_gone = True
                    self.close_connection = True
                return ex.reply_status

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

        self._server = NoDelayHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._running = False

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        self._thread.start()
        self._running = True
        return self

    def stop(self) -> None:
        if self._running:
            self._server.shutdown()
            self._server.server_close()
            self._running = False

    # ---- deployment-plane admin (hot swap; registry/deploy.py) ----
    def _admin_version(self) -> dict:
        holder = self.pipeline_holder
        if holder is None:
            return {"version": None, "pipeline": None}
        pipeline, version = holder.get()
        return {"version": version, "pipeline": type(pipeline).__name__}

    def _admin_stats(self) -> dict:
        """Worker-local load snapshot (``GET /admin/stats``) — the fleet
        autoscaler's queue-depth signal, plus the last swap's warmup
        breakdown (the zero-cold-start evidence a scale-up must show) and
        the resident model set on multi-model workers."""
        out = {
            **self._admin_version(),
            "queue_depth": self._queue.qsize(),
            "pending": len(self._pending),
            "draining": self.draining,
            "uptime_s": round(time.monotonic() - self.started_at, 3),
            "swap": self.last_swap_report,
        }
        if self.residency is not None:
            out["resident"] = self.residency.resident()
            out["resident_bytes"] = self.residency.resident_bytes()
        if self.llm_stats_fn is not None:
            try:
                out["llm"] = self.llm_stats_fn()
            except Exception:  # noqa: BLE001 — stats must not fail /admin
                out["llm"] = None
        return out

    def _admin_drain(self, body: bytes) -> tuple[int, dict]:
        """``POST /admin/drain``: stop accepting new requests (terminal
        503s, never queued-then-abandoned), let the serve loop finish the
        queued backlog so every already-accepted exchange gets its real
        reply (zero dropped exchanges: the terminal-reply
        discipline), then fire ``on_drained`` (worker entrypoints
        deregister from the WorkerRegistry and exit there). The reply
        returns immediately with the backlog size; drain completes
        asynchronously — poll ``/admin/stats`` or the registry table for
        completion. Body: ``{"timeout_s": <backlog deadline, default 30>}``
        — exchanges still unfinished at the deadline receive terminal 503s
        rather than holding the drain open forever."""
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            timeout_s = float(payload.get("timeout_s", 30.0))
            migrate_to = payload.get("migrate_to")
            if migrate_to is not None and not isinstance(migrate_to, str):
                raise ValueError("migrate_to must be a URL string")
        except (json.JSONDecodeError, UnicodeDecodeError, TypeError,
                ValueError) as e:
            return 400, {"error": f"bad drain body: {e}"}
        with self._lock:  # two racing drains must start ONE waiter (and
            already = self.draining  # fire on_drained once)
            self.draining = True
            if migrate_to:
                # live drain: the token scheduler exports active sequences
                # and hands them to peers through this front instead of
                # running them to completion
                self.migrate_to = migrate_to
        backlog = self._queue.qsize()
        pending = len(self._pending)
        if not already:
            self._drain_thread = threading.Thread(
                target=self._drain_and_finish, args=(timeout_s,),
                daemon=True)
            self._drain_thread.start()
        return 200, {"ok": True, "draining": True, "backlog": backlog,
                     "pending": pending, "already_draining": already}

    def _drain_and_finish(self, timeout_s: float) -> None:
        # the /admin/drain handler writes its 200 AFTER starting this
        # thread — on an empty backlog the waiter would otherwise complete
        # instantly and on_drained (server stop / process exit) could cut
        # the drain reply itself off mid-write
        time.sleep(0.1)
        deadline = time.monotonic() + max(timeout_s, 0.0)
        barrier = self.drain_barrier
        if barrier is not None:
            # the token scheduler's sequences live OUTSIDE _pending (their
            # streaming handlers already dequeued) — wait for it to migrate
            # or finish every live sequence before declaring settled
            try:
                barrier(max(deadline - time.monotonic(), 0.0))
            except Exception:  # noqa: BLE001 — a barrier bug must not
                pass           # wedge the drain
        while time.monotonic() < deadline:
            with self._lock:
                settled = not self._pending and not self._admitting
            if settled and self._queue.qsize() == 0:
                break
            time.sleep(0.02)
        # anything STILL parked past the deadline gets a terminal reply —
        # a drain may time a slow pipeline out, but it never silently
        # abandons an accepted exchange
        with self._lock:
            stuck = list(self._pending.values())
        for ex in stuck:
            ex.respond({"error": "worker drained before this request "
                                 "finished"}, status=503)
        if stuck:
            # the responds above only WAKE the parked handler threads; give
            # them a bounded window to actually write the 503s before
            # on_drained (which may os._exit) can cut the sockets off
            flush_deadline = time.monotonic() + 5.0
            while time.monotonic() < flush_deadline:
                with self._lock:
                    if not self._pending:
                        break
                time.sleep(0.02)
            # handlers pop _pending BEFORE writing the response bytes; a
            # short grace covers the final socket writes
            time.sleep(0.25)
        outcome = "ok" if not stuck else "timeout"
        _SERVING_METRICS.get()["drains"].inc(outcome=outcome)
        report = {"outcome": outcome, "stuck": len(stuck)}
        callback = self.on_drained
        if callback is not None:
            try:
                callback(report)
            except Exception:  # noqa: BLE001 — a callback bug must not
                pass           # leave the worker half-drained

    def _warmup(self, stage, rows: list,
                buckets: "list[int] | None" = None) -> int:
        """Run ``rows`` (JSON-able request bodies) through ``stage`` with
        the SAME batch preparation the serve loop uses. When ``buckets`` is
        set (or the server has a configured ladder), the rows are cycled up
        to EACH bucket size and transformed once per bucket — every serve
        rung's executable compiles through the CompiledCache before the
        swap, so a hot-swap never pays first-request compile latency
        (zero-compile-stall beside the zero-drop guarantee). Raises
        on any transform failure — a pipeline that cannot serve its warmup
        batch must never be swapped in."""
        if buckets is None:
            buckets = list(self._warmup_buckets)
        return run_warmup(stage, rows, buckets, self._loop_cfg)

    def _admin_load(self, body: bytes) -> tuple[int, dict]:
        """Load a new pipeline version side-by-side, warm it, atomically
        swap. Body: ``{"path": <stage dir>}`` or ``{"registry": <root or
        url>, "model": <name>, "ref": <version or alias>}``, plus optional
        ``"version"`` label and ``"warmup"`` (list of request bodies). The
        old pipeline keeps serving until the instant of the swap; a load or
        warmup failure leaves it untouched (409). ``"warmup_buckets"``
        overrides the precompile sizes (default: the server's configured
        bucket ladder).

        Registry artifacts load through the warmup route
        (``registry/aot.py``): the manifest's ``autotune`` winners are
        pinned and its ``sharding`` applied before the warmup. A manifest
        that carries ``aot.entries`` logs one structured warning and warms
        up by JIT, replaying its recorded rows when the body brings none:
        the swap never fails on it. The reply carries a ``warmup``
        breakdown (mode, io_ms, compile_ms, executables traced, rows,
        autotune, sharding). ``"autotune": false`` opts out of the pinning
        per load."""
        holder = self.pipeline_holder
        if holder is None:
            return 409, {"error": "this server has no swappable pipeline "
                                  "(started without serve_pipeline?)"}
        try:
            payload = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return 400, {"error": f"bad JSON body: {e}"}
        if not isinstance(payload, dict):
            return 400, {"error": "body must be a JSON object"}
        t0 = time.perf_counter()
        manifest = None
        stage = None
        fallback_reason = None
        autotune_applied = None
        cache = cb.get_compiled_cache()
        try:
            if "path" in payload:
                from ..core.serialization import load_stage

                stage = load_stage(payload["path"])
                version = (payload.get("version")
                           or os.path.basename(
                               str(payload["path"]).rstrip("/")))
            elif "registry" in payload and "model" in payload:
                from ..registry.registry import ModelRegistry

                resolved = ModelRegistry(payload["registry"]).resolve(
                    payload["model"], payload.get("ref", "latest"))
                stage, version = resolved.stage, resolved.version
                manifest = resolved.manifest
            else:
                return 400, {"error":
                             "body needs 'path' or 'registry'+'model'"}
            resolve_ms = (time.perf_counter() - t0) * 1e3
            from ..registry import aot as raot

            # pin the artifact's autotuned backends before any warmup
            tune = (manifest or {}).get("autotune")
            if tune and payload.get("autotune", True):
                from ..registry.autotune import apply_autotune

                autotune_applied = apply_autotune(stage, tune)
            # re-apply the artifact's declarative sharding BEFORE warmup; a
            # mesh this world cannot build demotes to a replicated load
            # with one structured warning, never a failed swap
            sharding_note = None
            shard_sec = (manifest or {}).get("sharding")
            if shard_sec:
                from ..parallel import partition as pshard

                applied, reason = pshard.apply_manifest_sharding(
                    stage, shard_sec,
                    enabled=payload.get("sharding", True),
                    model=payload.get("model"), version=version)
                sharding_note = "applied" if applied \
                    else f"replicated ({reason})"
            aot_cfg = (manifest or {}).get("aot") or {}
            warmup_rows = payload.get("warmup") or []
            warmup_buckets = payload.get("warmup_buckets")
            if aot_cfg.get("entries"):
                # executables of another runtime (the JAX package's): this
                # one serves none, so the load warms up by JIT, with the
                # manifest-recorded rows when the body brings none
                fallback_reason = raot.load_blocker(aot_cfg)
                warmup_rows = (warmup_rows
                               or (aot_cfg.get("warmup") or {}).get("rows")
                               or [])
                raot.log_fallback(fallback_reason, model=payload.get("model"),
                                  version=version)
            stats0 = cache.stats()
            warmed = self._warmup(stage, warmup_rows, warmup_buckets)
            stats1 = cache.stats()
        except Exception as e:  # noqa: BLE001 - any failure must 409, not swap
            if stage is not None:
                # the discarded candidate's warmed entries would otherwise
                # pin its weights in the cache with no owner to evict them
                cb.release_executables(stage)
            _SERVING_METRICS.get()["swaps"].inc(outcome="failed")
            return 409, {"error": f"{type(e).__name__}: {e}"}
        breakdown = {
            "mode": "jit",
            "fallback_reason": fallback_reason,
            "io_ms": round(resolve_ms, 2),
            "compile_ms": round(stats1["trace_ms_total"]
                                - stats0["trace_ms_total"], 2),
            "aot_hits": 0,
            "aot_misses": 0,
            "aot_errors": 0,
            "executables_loaded": 0,
            "executables_traced": stats1["misses"] - stats0["misses"],
            "rows": warmed,
        }
        if autotune_applied:
            breakdown["autotune"] = autotune_applied
        if sharding_note is not None:
            breakdown["sharding"] = sharding_note
        raot.emit_load_metrics(breakdown)
        replaced = holder.pipeline
        previous = holder.swap(stage, version)
        # evict the replaced pipeline's callables: every swap would
        # otherwise pin one more dead model's weights in the CompiledCache
        # (in-flight batches on the old pipeline keep the callables they
        # hold; they just cannot be acquired again)
        if replaced is not stage:
            cb.release_executables(replaced)
        self.last_swap_report = breakdown
        _SERVING_METRICS.get()["swaps"].inc(outcome="ok")
        return 200, {"ok": True, "version": version, "previous": previous,
                     "warmup_rows": warmed, "warmup": breakdown,
                     "load_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    # ---- micro-batch source/sink API (HTTPMicroBatchReader / HTTPWriter) ----
    def _empty_batch(self) -> DataFrame:
        """The schema'd empty batch (not an empty-dict partition, which
        breaks downstream schema checks). Built ONCE and reused — the serve
        loop polls this on every idle tick, and four fresh numpy arrays per
        poll was measurable allocator churn. Callers only read it."""
        cached = self.__dict__.get("_empty_batch_cache")
        if cached is None:
            empty = np.empty(0, dtype=object)
            cached = DataFrame([{"id": empty, "method": empty.copy(),
                                 "path": empty.copy(), "body": empty.copy()}])
            self.__dict__["_empty_batch_cache"] = cached
        return cached

    def _finish_batch(self, exchanges: list) -> DataFrame:
        """Exchanges -> DataFrame, dropping requests whose reply deadline
        already passed (their handler thread has 504'd and gone — feeding
        them to the pipeline would burn compute a slow batch can't spare)
        and recording queue-wait + occupancy."""
        now = time.perf_counter()
        live, dropped = [], []
        for e in exchanges:
            (live if now - e.enqueued_at < self.reply_timeout_s
             else dropped).append(e)
        m = _SERVING_METRICS.get()
        if dropped:
            m["expired"].inc(len(dropped))
            # terminal reply for every dropped exchange: a handler racing
            # the deadline (clock skew, a just-under-the-wire dequeue) must
            # wake NOW with an error, never park out its full timeout on a
            # request the scheduler has already abandoned
            for e in dropped:
                e.respond({"error": "request expired in queue before "
                                    "batch pickup"}, status=504)
        if not live:
            return self._empty_batch()
        # queue wait = enqueue -> drained into a batch (the micro-batch
        # scheduling delay, distinct from transform time)
        qw = m["queue_wait"]
        for e in live:
            qw.observe((now - e.enqueued_at) * 1e3)
        m["batch_rows"].observe(len(live))
        return DataFrame([{
            "id": np.asarray([e.request_id for e in live], dtype=object),
            "method": np.asarray([e.method for e in live], dtype=object),
            "path": np.asarray([e.path for e in live], dtype=object),
            "body": np.asarray([e.body for e in live], dtype=object),
        }])

    def read_batch(self, max_rows: int = 1024, timeout_s: float = 0.1) -> DataFrame:
        """Drain queued requests into a DataFrame (id, method, path, body) —
        the fixed-timeout scheduler: returns as soon as anything is queued."""
        exchanges: list[_Exchange] = []
        try:
            exchanges.append(self._queue.get(timeout=timeout_s))
            while len(exchanges) < max_rows:
                exchanges.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        if not exchanges:
            return self._empty_batch()
        return self._finish_batch(exchanges)

    def read_batch_adaptive(self, max_rows: int = 1024,
                            latency_budget_s: float = 0.01,
                            poll_timeout_s: float = 0.05,
                            ladder: "tuple[int, ...] | None" = None,
                            min_fill: int = 2) -> DataFrame:
        """Continuous-batching scheduler: drain what's queued, then

        * flush IMMEDIATELY when the batch exactly fills a ladder rung (a
          full bucket's worth is queued — zero padding, no reason to wait),
        * flush immediately when fewer than ``min_fill`` requests showed up
          (an idle queue: waiting would only add latency at low load),
        * otherwise wait for more — but never past the OLDEST queued
          request's latency budget, so the per-request deadline bounds batch
          assembly and a slow batch cannot starve the queue.

        Expired requests (handler already 504'd) are dropped, not served."""
        rungs = frozenset(ladder if ladder is not None
                          else cb.default_bucketer().ladder)
        try:
            first = self._queue.get(timeout=poll_timeout_s)
        except queue.Empty:
            return self._empty_batch()
        exchanges = [first]
        deadline = first.enqueued_at + latency_budget_s
        while len(exchanges) < max_rows:
            try:
                # drain the backlog greedily — a deep queue fills toward
                # max_rows before any rung/budget decision
                exchanges.append(self._queue.get_nowait())
                continue
            except queue.Empty:
                pass
            if len(exchanges) in rungs:
                break  # a full bucket's worth is queued: flush early
            if len(exchanges) < min_fill:
                break  # idle queue: flush now, don't tax low-load latency
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break  # the oldest request's budget is spent
            try:
                exchanges.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return self._finish_batch(exchanges)

    def exchange_for(self, request_id: str) -> "_Exchange | None":
        """The still-parked exchange for ``request_id`` (None once its
        handler gave up) — the token scheduler uses it to stream chunks
        back through the originating connection."""
        with self._lock:
            return self._pending.get(str(request_id))

    def reply_batch(self, df: DataFrame, id_col: str = "id",
                    reply_col: str = "reply", status: int = 200) -> int:
        """Route replies back by request id (``HTTPSinkV2`` / ``ServingUDFs``)."""
        if df.is_empty():
            return 0
        ids = df.collect_column(id_col)
        replies = df.collect_column(reply_col)
        # one lock acquisition for the whole batch (was once per row);
        # respond() happens outside the lock — it only sets the handler's
        # Event, and holding _lock across N wakeups would serialize them
        with self._lock:
            found = [(self._pending.get(str(rid)), reply)
                     for rid, reply in zip(ids, replies)]
        n = 0
        logger = self.request_logger
        now = time.perf_counter()
        holder = self.pipeline_holder
        version = holder.version if holder is not None else None
        for ex, reply in found:
            if ex is not None:
                ex.respond(reply, status=status)
                n += 1
                if logger is not None:
                    # after respond(): the handler thread is already awake,
                    # the log call cannot add to its latency
                    logger.log(method=ex.method, path=ex.path, body=ex.body,
                               reply=reply, status=status,
                               latency_ms=(now - ex.enqueued_at) * 1e3,
                               version=version)
        return n


def run_warmup(stage, rows: list, buckets: list, loop_cfg: dict) -> int:
    """The one warmup drive shared by ``/admin/load`` (before a hot swap)
    and the publish-time autotune search (``registry/autotune.py``): cycle
    ``rows`` (JSON-able request bodies) up to each bucket size and
    transform once per bucket through the serve loop's own batch
    preparation, with grad off in the calling thread. Returns the rows
    driven."""
    if not rows:
        return 0
    bodies = [r if isinstance(r, bytes)
              else (r.encode() if isinstance(r, str)
                    else json.dumps(r).encode()) for r in rows]
    sizes = sorted({int(b) for b in buckets} | {len(bodies)})
    total = 0
    for size in sizes:
        batch_bodies = [bodies[i % len(bodies)] for i in range(size)]
        batch = DataFrame([{
            "id": np.asarray([f"warmup-{i}" for i in range(size)],
                             dtype=object),
            "method": np.asarray(["POST"] * size, dtype=object),
            "path": np.asarray(["/"] * size, dtype=object),
            "body": np.asarray(batch_bodies, dtype=object),
        }])
        batch = _prepare_batch(batch, **loop_cfg)
        with torch.no_grad():
            stage.transform(batch)
        total += size
    return total


def _prepare_batch(batch: DataFrame, parse_json: bool = True,
                   input_col: str = "body") -> DataFrame:
    """Request-batch input preparation, shared verbatim between the serve
    loop and the /admin/load warmup path."""
    if parse_json:
        def parse(p):
            out = np.empty(len(p["body"]), dtype=object)
            for i, b in enumerate(p["body"]):
                try:
                    out[i] = json.loads(b.decode() or "null")
                except (json.JSONDecodeError, UnicodeDecodeError):
                    out[i] = None
            return out

        return batch.with_column(input_col, parse)
    if input_col != "body":
        return batch.with_column(input_col, lambda p: p["body"])
    return batch


def serve_pipeline(pipeline, port: int = 0, batch_interval_ms: int = 10,
                   input_col: str = "body", reply_col: str = "reply",
                   parse_json: bool = True, num_threads: int = 1,
                   version: str | None = None,
                   scheduler: str = "adaptive",
                   latency_budget_ms: float | None = None,
                   bucket_ladder=None,
                   max_batch_rows: int = 1024) -> ServingServer:
    """Run a Transformer as an HTTP service: request body -> ``input_col`` ->
    pipeline.transform -> ``reply_col`` -> response body. ``batch_interval_ms=0``
    replies per-request (continuous mode); ``num_threads`` transform loops
    drain the queue concurrently (for pipelines that release the GIL or do
    IO — the reference's concurrent continuous path).

    Micro-batch mode runs the CONTINUOUS-BATCHING scheduler by default
    (``scheduler="adaptive"``): flush as soon as a full bucket ladder rung
    is queued, wait up to ``latency_budget_ms`` (default: the batch
    interval) otherwise, and never past the oldest request's budget.
    ``scheduler="fixed"`` keeps the old fixed-timeout poll (the A/B
    baseline the serving-microbatch bench compares against).
    ``bucket_ladder`` pins the flush rungs AND the ``/admin/load`` warmup
    precompile set; by default both resolve to the process-wide pow-2
    ladder capped at ``max_batch_rows``, so a warmed hot swap never
    compile-stalls at any rung the scheduler can flush.

    The pipeline lives in a :class:`PipelineHolder` (``version`` labels the
    initial one; pass a holder directly to share it), so ``POST /admin/load``
    can hot-swap a new version mid-serve: in-flight batches finish on the
    old pipeline, the next batch reads the new one — zero dropped requests."""
    if scheduler not in ("adaptive", "fixed"):
        raise ValueError(f"scheduler must be 'adaptive' or 'fixed', "
                         f"got {scheduler!r}")
    server = ServingServer(port=port)
    holder = (pipeline if isinstance(pipeline, PipelineHolder)
              else PipelineHolder(pipeline, version))
    server.pipeline_holder = holder
    server._loop_cfg = {"parse_json": parse_json, "input_col": input_col}
    if bucket_ladder is not None:
        # explicit config: flush AND warm the full ladder (the caller opted
        # into its warmup cost for the zero-compile-stall guarantee)
        server._bucket_ladder = tuple(sorted({int(b) for b in bucket_ladder}))
        server._warmup_buckets = server._bucket_ladder
    elif batch_interval_ms != 0:
        # default micro-batch mode: flush at the process-wide ladder, but
        # precompile only the latency-sensitive small rungs — warming a
        # heavy model at every rung up to 1024 rows can outlast the deploy
        # plane's /admin/load timeout, and large batches amortize a compile
        # stall across their rows anyway
        server._bucket_ladder = tuple(
            b for b in cb.default_bucketer().ladder if b <= max_batch_rows)
        server._warmup_buckets = tuple(
            b for b in server._bucket_ladder if b <= _DEFAULT_WARMUP_CAP)
    budget_s = (batch_interval_ms if latency_budget_ms is None
                else latency_budget_ms) / 1000.0
    server.start()

    def read_next() -> DataFrame:
        if batch_interval_ms == 0:  # continuous: one row, reply per request
            return server.read_batch(max_rows=1, timeout_s=0.01)
        if scheduler == "fixed":
            return server.read_batch(
                max_rows=max_batch_rows,
                timeout_s=max(batch_interval_ms, 10) / 1000.0)
        return server.read_batch_adaptive(
            max_rows=max_batch_rows, latency_budget_s=budget_s,
            poll_timeout_s=max(batch_interval_ms, 10) / 1000.0,
            ladder=server._bucket_ladder)

    @torch.no_grad()
    def loop():
        while server._running:
            batch = read_next()
            if batch.is_empty():
                continue
            batch = _prepare_batch(batch, parse_json=parse_json,
                                   input_col=input_col)
            stage, _version = holder.get()
            try:
                replied = stage.transform(batch)
                server.reply_batch(replied, reply_col=reply_col)
            except Exception as e:  # noqa: BLE001 - serve loop must survive
                err = {"error": str(e)}
                fallback = batch.with_column(reply_col,
                                             lambda p: np.asarray([err] * len(p["id"]),
                                                                  dtype=object))
                server.reply_batch(fallback, reply_col=reply_col, status=500)

    for _ in range(max(num_threads, 1)):
        threading.Thread(target=loop, daemon=True).start()
    return server


def serve_llm(stage, port: int = 0, poll_ms: float = 20.0,
              latency_budget_ms: float = 5.0, max_new_tokens_cap: int = 1024,
              max_waiting: int = 256, version: str | None = None,
              warmup: bool = True) -> ServingServer:
    """Token-granular LLM serving: the continuous-batching TOKEN scheduler
    over a paged-KV decode engine (``models/paged_engine.py``).

    ``stage`` is a causal-LM transformer exposing ``serving_engine()``
    (:class:`~synapseml_torch.hf.HuggingFaceCausalLM`) or a
    :class:`PipelineHolder` of one. Request body::

        {"prompt": "...", "max_new_tokens": 32, "stream": false}

    Unlike ``serve_pipeline`` (whole-request micro-batches), the loop
    interleaves at token granularity: queued requests drain through
    ``read_batch_adaptive`` and PREFILL between decode steps, every decode
    step advances all active sequences one token, and a sequence that emits
    EOS or exhausts its budget frees its KV pages and decode slot
    immediately — no run-to-completion barrier, so short generations never
    wait out a long neighbor's tail. ``stream: true`` replies are chunked
    NDJSON (one ``{"token", "text"}`` object per token, then a terminal
    ``{"done": true, ...}`` record); non-streaming requests get one final
    JSON reply. Any request the scheduler dequeues but cannot serve (bad
    payload, overload, engine swap) receives a TERMINAL error reply — a
    client never blocks to its full timeout on a silently-dropped request.

    ``POST /admin/load`` hot-swaps stay zero-compile-stall: the loop
    rebuilds the engine from the swapped-in stage and ``warmup()``
    precompiles every prefill rung (seq ladder) and decode rung (slot
    ladder) BEFORE the new engine takes a request; the old engine's
    executables are evicted."""
    holder = (stage if isinstance(stage, PipelineHolder)
              else PipelineHolder(stage, version))
    if not hasattr(holder.pipeline, "serving_engine"):
        raise TypeError(
            f"serve_llm needs a stage exposing serving_engine() (e.g. "
            f"HuggingFaceCausalLM); got {type(holder.pipeline).__name__} — "
            f"use serve_pipeline for whole-request stages")
    server = ServingServer(port=port)
    server.pipeline_holder = holder
    server._loop_cfg = {"parse_json": True, "input_col": "prompt"}
    server.start()

    def build_engine(st):
        eng = st.serving_engine()
        if warmup:
            eng.warmup()
        return eng

    open_streams: dict[str, object] = {}  # request_id -> exchange
    kept_local: set = set()  # request ids whose drain handoff failed
    state = {"engine": None}  # the drain barrier reads the live engine

    def dispatch(engine, events):
        for ev in events:
            seq = ev["seq"]
            rid = seq.request_id
            if rid is None:
                continue
            ex = open_streams.get(rid) or server.exchange_for(rid)
            if ex is None or getattr(ex, "client_gone", False):
                # handler timed out or the socket died mid-stream: stop
                # decoding into a dead connection — free pages + slot NOW
                if not ev["done"]:
                    engine.abort(seq, reason="client_gone")
                open_streams.pop(rid, None)
                continue
            if seq.stream:
                if rid not in open_streams:
                    ex.stream_begin()
                    open_streams[rid] = ex
                if ev["token"] is not None:
                    ch = engine.chunk_for(ev)
                    if isinstance(ch, dict):
                        # monotonic per-request chunk number = the GLOBAL
                        # token index, so a migrated/resumed continuation
                        # keeps counting where the origin stopped and the
                        # front's journal dedups across handoffs exactly;
                        # uid lets a crash resubmit keep the origin's
                        # sampling stream
                        ch.setdefault("seq", len(seq.generated) - 1)
                        ch.setdefault("uid", seq.uid)
                    ex.stream_chunk(ch)
                if ev["done"]:
                    res = engine.result_for(seq)
                    if isinstance(res, dict):
                        res.setdefault("seq", len(seq.generated))
                    ex.stream_chunk(res)
                    ex.stream_end()
                    open_streams.pop(rid, None)
            elif ev["done"]:
                # a deadline expiry is the worker's fault-containment 504,
                # not a successful generation
                status = (504 if ev.get("finish_reason") == "deadline"
                          else 200)
                ex.respond(engine.result_for(seq), status=status)

    def fail_inflight(engine, err, status=503):
        """TERMINAL replies for EVERY in-flight request when the engine
        goes away (hot swap, device failure): live streaming exchanges get
        an error chunk + stream end — never a silent hang to client
        timeout — and parked buffered exchanges get an error reply."""
        for rid, ex in list(open_streams.items()):
            ex.stream_chunk({"error": err, "done": True})
            ex.stream_end()
            open_streams.pop(rid, None)
        try:
            doomed = engine.abort_all()
        except Exception:  # noqa: BLE001 — a dead engine must not block
            doomed = []    # the terminal replies
        for seq in doomed:
            if not seq.request_id:
                continue
            ex = server.exchange_for(seq.request_id)
            if ex is None:
                continue
            if ex.streaming:
                # stream_begin happened but the handler hasn't dequeued
                # yet — terminal error rides the chunk channel
                ex.stream_chunk({"error": err, "done": True})
                ex.stream_end()
            else:
                ex.respond({"error": err}, status=status)

    def migrate_out(engine):
        """Live drain: export every front-relayed sequence and hand it to
        a peer via the front's /admin/migrate mailbox. On handoff failure
        the snapshot re-imports locally (the sequence finishes here under
        the drain barrier) — a failed migration degrades to the old
        run-to-completion drain, never to a lost request. A sequence gets
        one handoff attempt: the JAX loop retries every failed one at each
        step, exporting and re-importing its pages a step."""
        target = server.migrate_to
        if target is None or not hasattr(engine, "export"):
            return
        m = _SERVING_METRICS.get()
        for seq in list(engine.live_requests()):
            rid = seq.request_id
            key = getattr(seq, "journal_key", None)
            if rid is None or key is None or not seq.stream or rid in kept_local:
                continue  # not front-relayed (no peer can splice its
                #           stream) or its handoff failed: it finishes here
            t0 = time.perf_counter()
            n_emitted = len(seq.generated)
            snap = engine.export(seq.uid)
            if snap is None:
                continue
            ok = _post_json(target.rstrip("/") + "/admin/migrate",
                            {"key": key, "snapshot": snap})
            if ok:
                m["migrations"].inc(reason="drain", outcome="ok")
                m["migration_ms"].observe((time.perf_counter() - t0) * 1e3)
                ex = open_streams.pop(rid, None) \
                    or server.exchange_for(rid)
                if ex is not None:
                    # in-band handoff marker: the front stops reading this
                    # stream and splices the peer's continuation; seq-
                    # numbered chunks make the cutover dup/loss-free
                    ex.stream_chunk({"__migrated__": True,
                                     "seq": n_emitted})
                    ex.stream_end()
            else:
                m["migrations"].inc(reason="drain", outcome="error")
                kept_local.add(rid)
                try:
                    engine.import_snapshot(snap, rid, journal_key=key)
                except Exception:  # noqa: BLE001 — local re-import of a
                    pass           # just-exported snapshot
        # non-migratable work keeps decoding while draining; the drain
        # barrier holds on_drained until it finishes or times out

    def drain_barrier(budget_s: float) -> None:
        deadline = time.monotonic() + max(float(budget_s), 0.0)
        while time.monotonic() < deadline:
            eng = state["engine"]
            if eng is None or (not eng.has_work() and not open_streams):
                return
            time.sleep(0.02)

    server.drain_barrier = drain_barrier

    def llm_stats():
        # reads the LIVE engine (hot-swaps rebuild it), so /admin/stats
        # always reflects the serving engine, not the one at boot
        eng = state["engine"]
        if eng is None or not hasattr(eng, "stats"):
            return None
        return eng.stats()

    server.llm_stats_fn = llm_stats

    @torch.no_grad()
    def loop():
        # ONE consistent snapshot: a hot-swap landing during this (long,
        # warmup-heavy) build must still trip the v != current check below
        stage0, current = holder.get()
        engine = build_engine(stage0)
        state["engine"] = engine
        while server._running:
            try:
                engine, current = _iterate(engine, current)
                state["engine"] = engine
            except Exception as e:  # noqa: BLE001 — scheduler must survive
                # an engine failure fails every in-flight request with a
                # TERMINAL reply (never a silent stall to client timeout)
                fail_inflight(engine, f"engine failure: {e}")
                # the failed call may have left the page pool mid-step,
                # the engine unusable: rebuild it rather than retry
                try:
                    engine.release()
                    st, v = holder.get()
                    engine = build_engine(st)
                    state["engine"] = engine
                    current = v
                except Exception:  # noqa: BLE001 — retry next iteration
                    time.sleep(0.5)

    def _iterate(engine, current):
            stage_now, v = holder.get()
            if v != current:
                # hot swap: precompile the replacement's rungs, then cut
                # over between steps; in-flight sequences finish... they
                # cannot — the pages live in the old engine — so every one
                # of them (streaming AND buffered) gets a terminal error
                # instead of a silent stall
                old, engine = engine, build_engine(stage_now)
                state["engine"] = engine
                current = v
                fail_inflight(old, "pipeline hot-swapped mid-generation")
                old.release()
            if server.draining:
                migrate_out(engine)
            busy = engine.has_work()
            # busy: drain without blocking — a 1 ms queue wait would tax
            # EVERY decode step of every active sequence; idle: block on
            # the poll interval
            batch = server.read_batch_adaptive(
                max_rows=64, latency_budget_s=latency_budget_ms / 1e3,
                poll_timeout_s=(0.0 if busy else max(poll_ms, 1.0) / 1e3))
            if not batch.is_empty():
                ids = batch.collect_column("id")
                bodies = batch.collect_column("body")
                for rid, body in zip(ids, bodies):
                    rid = str(rid)
                    ex = server.exchange_for(rid)
                    if ex is None:
                        continue
                    if engine.waiting_count >= max_waiting:
                        ex.respond({"error": "LLM queue full"}, status=503)
                        continue
                    try:
                        payload = json.loads(body.decode() or "null")
                        deadline = None
                        dl = _header(ex.headers, "X-Deadline-Ms")
                        if dl is not None:
                            # client deadline propagates front -> worker as
                            # a remaining-budget header; the engine expires
                            # the sequence past it (pages freed, 504)
                            deadline = (time.perf_counter()
                                        + float(dl) / 1e3)
                        jkey = _header(ex.headers, "X-Request-Key")
                        if isinstance(payload, dict) \
                                and "__import__" in payload:
                            # live-migration continuation: adopt the peer's
                            # exported KV pages (or re-prefill on mismatch)
                            engine.import_snapshot(
                                payload["__import__"], rid,
                                deadline=deadline, journal_key=jkey)
                        elif isinstance(payload, dict) \
                                and "__resume__" in payload:
                            # crash-path resubmit from the front's journal:
                            # re-prefill over prompt + already-relayed ids
                            engine.resume(payload["__resume__"], rid,
                                          max_new_cap=max_new_tokens_cap,
                                          deadline=deadline,
                                          journal_key=jkey)
                        else:
                            engine.submit(payload, rid,
                                          max_new_cap=max_new_tokens_cap,
                                          deadline=deadline,
                                          journal_key=jkey)
                    except (ValueError, TypeError, KeyError, IndexError,
                            UnicodeDecodeError) as e:
                        # one malformed body is THAT client's 400, never an
                        # engine failure that aborts everyone else
                        ex.respond({"error": f"bad request: {e}"}, status=400)
            dispatch(engine, engine.admit())
            dispatch(engine, engine.step())
            return engine, current

    threading.Thread(target=loop, daemon=True).start()
    return server
