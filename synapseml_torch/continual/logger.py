"""Sampled request/response logging: production traffic → training source.

Counterpart of ``synapseml_tpu/continual/logger.py``. :class:`RequestLogger`
hooks into the serving tier (``RoutingFront.set_request_logger`` at the
fleet level, ``ServingServer.request_logger`` on a single worker) and turns
served traffic into jsonl shards a :class:`~synapseml_torch.data.source.
ShardedSource` can stream — the feedstock of the continual-training
flywheel.

Contracts, in priority order:

1. **SLO-safe** — :meth:`RequestLogger.log` runs on the serving thread and
   must never delay a reply: it draws the (seeded) sampling decision, does
   ONE non-blocking queue insert, and returns. A full queue sheds the
   record and counts it (``synapseml_continual_log_dropped_total``);
   scrubbing/serialization/IO all happen on the writer thread, which sees
   host values only (the serving planes reply with JSON-able host data)
   and touches no CUDA state.
2. **Scrubbed** — every payload passes through the ``core/logging``
   scrubber before it touches disk (named secrets, bearer/JWT tokens,
   emails, long digit runs), applied per string field so the shard stays
   valid JSON; numeric card-shaped values (12+ digits) mask too. Per-kind
   counts land on ``synapseml_scrub_fields_total`` and in each shard's
   DONE marker.
3. **Atomic shards** — records append to an in-flight temp file invisible
   to readers; at ``shard_rows`` the part commits via the scoring-sink
   discipline: fsync → ``os.replace`` to ``part-NNNNN.jsonl`` → atomic
   ``part-NNNNN.DONE`` marker (JSON: rows, bytes, scrub tally). A crash
   mid-shard loses at most the in-flight tail; a committed part is never
   torn. :func:`logged_request_source` reads ONLY DONE-gated parts.

Fault injection: the commit seam consults the active ``FaultPlan``
(``plan.on_continual("log_commit:<part>")``); an injected failure sheds
that shard's rows (counted) and the logger keeps going — degraded, never
corrupt.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
import time

from ..core import observability as obs
from ..core.faults import active_fault_plan
from ..core.logging import scrub_json
from ..registry.store import atomic_write_bytes

__all__ = ["RequestLogger", "logged_request_source"]

_PART_PREFIX = "part-"
_DONE_SUFFIX = ".DONE"

_LOG_METRICS = obs.HandleCache(lambda reg: {
    "rows": reg.counter(
        "synapseml_continual_logged_rows_total",
        "request/response records committed to logged shards", ("dir",)),
    "dropped": reg.counter(
        "synapseml_continual_log_dropped_total",
        "records shed before logging (full queue / commit failure / "
        "writer error)", ("reason",)),
    "scrubbed": reg.counter(
        "synapseml_continual_scrubbed_fields_total",
        "fields masked while writing logged shards", ("kind",)),
    "parts": reg.counter(
        "synapseml_continual_log_parts_total",
        "jsonl shards committed by the request logger", ("dir",)),
})


def _decode_payload(payload):
    """bytes → parsed JSON when possible, utf-8 text otherwise; everything
    else passes through (the serve loop hands dict replies directly)."""
    if isinstance(payload, (bytes, bytearray)):
        text = bytes(payload).decode("utf-8", errors="replace")
        try:
            return json.loads(text or "null")
        except json.JSONDecodeError:
            return text
    return payload


class RequestLogger:
    """Bounded async request/response logger writing ShardedSource-layout
    jsonl shards. Attach with ``front.set_request_logger(lg)`` or
    ``server.request_logger = lg``; both call :meth:`log` after each reply.

    ``sample_rate`` draws from ONE seeded RNG so a test (or a replayed
    trace) sees a deterministic kept-set; ``shard_rows`` bounds part size;
    ``max_queue`` bounds memory — the writer sheds, it never backpressures
    the serving thread."""

    def __init__(self, path: str, sample_rate: float = 1.0, seed: int = 0,
                 shard_rows: int = 256, max_queue: int = 4096,
                 scrub_payloads: bool = True):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got "
                             f"{sample_rate}")
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.sample_rate = float(sample_rate)
        self.shard_rows = int(shard_rows)
        self.scrub_payloads = bool(scrub_payloads)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._next_part = self._scan_next_part()
        self._inflight_path: str | None = None
        self._inflight_f = None
        self._inflight_rows = 0
        self._inflight_scrubs: dict[str, int] = {}
        self.logged = 0       # rows committed to DONE'd parts
        self.dropped = 0      # shed records (all reasons)
        self._pending_rows = 0  # written to the in-flight part, not committed
        self._closed = False
        self._wake = threading.Event()
        self._flush_req: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._run, daemon=True,
                                        name="request-logger")
        self._writer.start()

    # -- serving-thread surface (must never block) --------------------------
    def log(self, *, method: str, path: str, body, reply, status: int,
            latency_ms: float, version: str | None = None) -> None:
        """Record one served exchange. Runs on the serving thread: sampling
        draw + one ``put_nowait``; a full queue sheds the record."""
        if self._closed:
            return
        if self.sample_rate < 1.0:
            with self._rng_lock:
                if self._rng.random() >= self.sample_rate:
                    return
        record = (time.time(), method, path, body, reply, int(status),
                  float(latency_ms), version)
        try:
            self._queue.put_nowait(record)
        except queue.Full:
            self.dropped += 1
            _LOG_METRICS.get()["dropped"].inc(reason="queue_full")

    # -- writer thread ------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._closed and self._queue.empty():
                    return
                self._serve_flush_requests()
                continue
            if item is None:  # close sentinel
                return
            try:
                self._write_record(item)
            except Exception:  # noqa: BLE001 — logging must never die
                self.dropped += 1
                _LOG_METRICS.get()["dropped"].inc(reason="writer_error")
            self._serve_flush_requests()

    def _serve_flush_requests(self) -> None:
        while True:
            try:
                done_evt = self._flush_req.get_nowait()
            except queue.Empty:
                return
            try:
                self._drain_queue()
                self._commit_part()
            finally:
                done_evt.set()

    def _drain_queue(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            try:
                self._write_record(item)
            except Exception:  # noqa: BLE001
                self.dropped += 1
                _LOG_METRICS.get()["dropped"].inc(reason="writer_error")

    def _write_record(self, item) -> None:
        ts, method, path, body, reply, status, latency_ms, version = item
        record = {"ts": ts, "method": method, "path": path,
                  "status": status, "latency_ms": round(latency_ms, 3),
                  "body": _decode_payload(body),
                  "reply": _decode_payload(reply)}
        if version is not None:
            record["version"] = version
        if self._inflight_f is None:
            # open BEFORE scrubbing: _open_part resets the scrub tally, so
            # scrubbing first would drop the first record's counts from
            # every shard's DONE marker
            self._open_part()
        if self.scrub_payloads:
            # the structural core scrubber: per-field masking keeps the
            # shard valid JSON (a textual digit mask on a bare number
            # would not), secret-worded keys mask their values
            record = scrub_json(record, self._inflight_scrubs)
        line = json.dumps(record, default=str) + "\n"
        self._inflight_f.write(line.encode())
        self._inflight_rows += 1
        self._pending_rows += 1
        if self._inflight_rows >= self.shard_rows:
            self._commit_part()

    # -- shard lifecycle ----------------------------------------------------
    def _scan_next_part(self) -> int:
        taken = [-1]
        for name in os.listdir(self.path):
            if name.startswith(_PART_PREFIX) and name.endswith(".jsonl"):
                try:
                    taken.append(int(name[len(_PART_PREFIX):-len(".jsonl")]))
                except ValueError:
                    continue
        return max(taken) + 1

    def _part_name(self, index: int) -> str:
        return f"{_PART_PREFIX}{index:05d}.jsonl"

    def _open_part(self) -> None:
        # the leading dot keeps the in-flight file invisible to part globs
        self._inflight_path = os.path.join(
            self.path, f".inflight-{self._next_part:05d}.tmp")
        self._inflight_f = open(self._inflight_path, "wb")
        self._inflight_rows = 0
        self._inflight_scrubs = {}

    def _commit_part(self) -> None:
        """Commit the in-flight part: fsync → rename → DONE marker (the
        scoring-sink atomic discipline). A failure — injected via the
        ``continual`` fault plane or real — sheds this shard's rows
        (counted) rather than leaving a torn committed part."""
        if self._inflight_f is None or self._inflight_rows == 0:
            if self._inflight_f is not None:
                self._abort_part()
            return
        name = self._part_name(self._next_part)
        rows, scrubs = self._inflight_rows, dict(self._inflight_scrubs)
        try:
            plan = active_fault_plan()
            if plan is not None:
                plan.on_continual(f"log_commit:{name}")
            self._inflight_f.flush()
            os.fsync(self._inflight_f.fileno())
            self._inflight_f.close()
            final = os.path.join(self.path, name)
            os.replace(self._inflight_path, final)
            size = os.path.getsize(final)
            atomic_write_bytes(
                final + _DONE_SUFFIX,
                json.dumps({"rows": rows, "bytes": size,
                            "scrubbed": scrubs}).encode())
        except Exception:  # noqa: BLE001 — shed, don't corrupt
            self._abort_part()
            self.dropped += rows
            self._pending_rows -= rows
            _LOG_METRICS.get()["dropped"].inc(rows, reason="commit_failed")
            self._next_part += 1  # never reuse a possibly-littered index
            return
        self._inflight_f = None
        self._inflight_path = None
        self._inflight_rows = 0
        self.logged += rows
        self._pending_rows -= rows
        m = _LOG_METRICS.get()
        m["rows"].inc(rows, dir=self.path)
        m["parts"].inc(dir=self.path)
        for kind, n in scrubs.items():
            m["scrubbed"].inc(n, kind=kind)
        self._next_part += 1

    def _abort_part(self) -> None:
        try:
            if self._inflight_f is not None:
                self._inflight_f.close()
            if self._inflight_path and os.path.exists(self._inflight_path):
                os.remove(self._inflight_path)
        except OSError:
            pass
        self._inflight_f = None
        self._inflight_path = None
        self._inflight_rows = 0

    # -- reader surface -----------------------------------------------------
    def flush(self, timeout_s: float = 10.0) -> None:
        """Drain the queue and commit the current partial shard — call
        before building a training source so the freshest traffic is
        readable. Processed ON the writer thread (one writer, no interleaved
        file state)."""
        if self._closed:
            return
        evt = threading.Event()
        self._flush_req.put(evt)
        if not evt.wait(timeout_s):
            raise TimeoutError("request logger flush timed out")

    def committed_parts(self) -> list[str]:
        """DONE-gated committed part paths, in commit order."""
        out = []
        for name in sorted(os.listdir(self.path)):
            if not (name.startswith(_PART_PREFIX)
                    and name.endswith(".jsonl")):
                continue
            if os.path.exists(os.path.join(self.path, name + _DONE_SUFFIX)):
                out.append(os.path.join(self.path, name))
        return out

    def source(self, shard_bytes: int | None = None):
        """The committed log as a :class:`~synapseml_torch.data.ShardedSource`
        (jsonl kind) — feed it to ``fit_source`` / the continual loop."""
        return logged_request_source(self.path, shard_bytes=shard_bytes)

    def stats(self) -> dict:
        return {"logged": self.logged, "dropped": self.dropped,
                "pending": self._pending_rows + self._queue.qsize(),
                "parts": len(self.committed_parts()),
                "next_part": self._next_part}

    def close(self, timeout_s: float = 10.0) -> None:
        if self._closed:
            return
        try:
            self.flush(timeout_s)
        finally:
            self._closed = True
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # the writer's closed+empty check ends the thread
            self._writer.join(timeout=timeout_s)

    def __enter__(self) -> "RequestLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def logged_request_source(path: str, shard_bytes: int | None = None):
    """A :class:`~synapseml_torch.data.ShardedSource` over the DONE-committed
    request-log parts under ``path`` — in-flight and torn parts are
    invisible by construction (the atomic part/DONE discipline)."""
    from ..data.source import DEFAULT_SHARD_BYTES, ShardedSource

    parts = []
    for name in sorted(os.listdir(path)):
        if not (name.startswith(_PART_PREFIX) and name.endswith(".jsonl")):
            continue
        if os.path.exists(os.path.join(path, name + _DONE_SUFFIX)):
            parts.append(os.path.join(path, name))
    if not parts:
        raise FileNotFoundError(
            f"no committed request-log parts under {path!r} (flush the "
            "logger, or serve some traffic first)")
    return ShardedSource.jsonl(
        parts, shard_bytes=shard_bytes or DEFAULT_SHARD_BYTES)
