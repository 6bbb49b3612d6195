"""``transform_source``: stream an out-of-core source through a fitted
stage into an exactly-once sharded sink.

Counterpart of ``synapseml_tpu/scoring/runner.py``: the offline batch
workload (backfills, embedding corpora, nightly scoring) that serving does
not cover, Spark's ``transform()`` over any size of DataFrame. Throughput
comes from overlapping I/O, host preparation and device compute, so the
runner is a three-stage bounded-queue pipeline:

    reader thread   -> shard read (retries, fault guards) and column selection
    calling thread  -> ladder batches through ``stage.transform`` (on the
                       stage's device; outputs come back as host arrays)
    writer thread   -> streamed part writes, DONE markers, cursor appends

Only the calling thread runs the stage, so the host threads never touch
the CUDA state it owns: they see numpy arrays only. Memory is bounded by
the queued shards and batches, never by the dataset. Exactly-once comes
from the sink (``scoring/sink.py``): a killed scan resumes by skipping
completed shards, with byte-identical output.

A shard whose reads exhaust the source's ``RetryPolicy``, or a row whose
transform raises, is quarantined to the errors sidecar
(``on_error='quarantine'``, the default; ``'raise'`` propagates). Sink
failures always propagate. The ``synapseml_scoring_*`` series and one
``scoring.shard`` span per shard land on the observability plane.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..core import batching as cb
from ..core import observability as obs
from ..core.dataframe import DataFrame
from ..data.source import ShardedSource, _n_rows
from .planner import ScoringPlan, iter_shard_batches, plan_scan
from .sink import ScoreSink

__all__ = ["transform_source", "ScoringReport", "ScoringContractError"]

_END = object()

_SCORING_METRICS = obs.HandleCache(lambda reg: {
    "rows": reg.counter(
        "synapseml_scoring_rows_total",
        "input rows scored and written to the sink", ("format",)),
    "padded": reg.counter(
        "synapseml_scoring_padded_rows_total",
        "pad rows added by bucket-ladder batch formation (wasted compute)",
        ("format",)),
    "shards": reg.counter(
        "synapseml_scoring_shards_total",
        "shards finished by outcome",
        ("format", "status")),  # done | skipped | quarantined
    "batch_ms": reg.histogram(
        "synapseml_scoring_batch_ms",
        "wall time of one batch through stage.transform", ("format",)),
    "quarantined_rows": reg.counter(
        "synapseml_scoring_quarantined_rows_total",
        "poisoned rows diverted to the errors sidecar", ("format",)),
    "read_queue": reg.gauge(
        "synapseml_scoring_read_queue_depth",
        "prefetched shards buffered ahead of the compute loop", ("format",)),
    "write_queue": reg.gauge(
        "synapseml_scoring_write_queue_depth",
        "scored batches buffered ahead of the sink writer", ("format",)),
    "rows_per_sec": reg.gauge(
        "synapseml_scoring_rows_per_sec",
        "scan throughput since the run started", ("format",)),
    "progress": reg.gauge(
        "synapseml_scoring_progress_pct",
        "scan progress for this host (shards seen / shards assigned)",
        ("format",)),
    "eta": reg.gauge(
        "synapseml_scoring_eta_s",
        "estimated seconds to scan completion for this host", ("format",)),
})


class ScoringContractError(RuntimeError):
    """The stage broke the bulk-scoring contract (e.g. changed the row
    count): a configuration error, never quarantined."""


@dataclasses.dataclass
class ScoringReport:
    """What one ``transform_source`` call did (one host's view)."""

    rows_written: int = 0
    rows_padded: int = 0
    batches: int = 0
    shards_assigned: int = 0
    shards_done: int = 0
    shards_skipped: int = 0        # resume: already complete in the sink
    rows_quarantined: int = 0
    shards_quarantined: int = 0
    wall_s: float = 0.0
    rows_per_sec: float = 0.0
    complete: bool = False         # whole scan (all hosts) — _SUCCESS written
    estimated_rows: int | None = None   # whole dataset, estimate_rows()
    peak_inflight_bytes: int = 0   # max bytes buffered across the queues
    parts: list = dataclasses.field(default_factory=list)
    sink_path: str = ""


def transform_source(stage, source: ShardedSource, sink: ScoreSink, *,
                     batch_rows: int = 256,
                     bucketer: cb.ShapeBucketer | None = None,
                     multiple_of: int = 1, pad_mode: str = "edge",
                     columns: list[str] | None = None,
                     host_index: int | None = None,
                     host_count: int | None = None,
                     on_error: str = "quarantine",
                     prefetch: int = 2, write_queue: int = 4,
                     estimate: bool = True) -> ScoringReport:
    """Score every row of ``source`` through ``stage.transform`` into
    ``sink``, exactly once, in bounded memory. See the module docstring;
    ``columns`` selects the input columns handed to the stage (heterogeneous
    corpora), ``batch_rows`` caps batch memory (chunking runs at ladder
    rungs <= it). Returns this host's :class:`ScoringReport`."""
    if not callable(getattr(stage, "transform", None)):
        raise TypeError(f"{type(stage).__name__} has no transform(); "
                        "transform_source needs a fitted Transformer")
    if on_error not in ("quarantine", "raise"):
        raise ValueError(f"on_error must be 'quarantine' or 'raise', "
                         f"got {on_error!r}")
    plan = plan_scan(source, batch_rows, bucketer, multiple_of,
                     host_index, host_count)
    b = bucketer or cb.default_bucketer()
    m = _SCORING_METRICS.get()
    fmt = sink.format
    report = ScoringReport(shards_assigned=len(plan.shard_indices),
                           sink_path=sink.path)

    done = sink.completed()
    todo = [i for i in plan.shard_indices if i not in done]
    report.shards_skipped = len(plan.shard_indices) - len(todo)
    if report.shards_skipped:
        m["shards"].inc(report.shards_skipped, format=fmt, status="skipped")
    if estimate:
        try:
            # read_fallback=False: a progress gauge must never cost a full
            # shard read (custom-reader sources just report no estimate)
            report.estimated_rows = source.estimate_rows(read_fallback=False)
        except Exception:  # noqa: BLE001 — progress is best-effort
            report.estimated_rows = None

    t_start = time.perf_counter()
    runner = _Runner(stage, source, sink, plan, b, pad_mode, columns,
                     on_error, prefetch, write_queue, report, m, fmt,
                     t_start)
    try:
        runner.run(todo)
    finally:
        runner.shutdown()
    end_done = sink.completed()  # ONE end-of-scan marker scan, reused
    report.complete = sink.finalize(plan.num_shards, done=end_done)
    report.wall_s = time.perf_counter() - t_start
    report.rows_per_sec = (report.rows_written / report.wall_s
                           if report.wall_s > 0 else 0.0)
    report.parts = sink.part_files(done=end_done)
    m["rows_per_sec"].set(report.rows_per_sec, format=fmt)
    return report


class _Runner:
    """One scan's thread plumbing (reader -> compute -> writer)."""

    def __init__(self, stage, source, sink, plan: ScoringPlan, bucketer,
                 pad_mode, columns, on_error, prefetch, write_queue,
                 report: ScoringReport, metrics, fmt, t_start):
        self.stage, self.source, self.sink, self.plan = stage, source, sink, plan
        self.bucketer, self.pad_mode = bucketer, pad_mode
        self.columns = list(columns) if columns else None
        self.on_error = on_error
        self.report, self.m, self.fmt = report, metrics, fmt
        self.t_start = t_start
        self._stop = threading.Event()
        self._read_q: "queue.Queue" = queue.Queue(maxsize=max(int(prefetch), 1))
        self._write_q: "queue.Queue" = queue.Queue(
            maxsize=max(int(write_queue), 1))
        self._writer_error: list[BaseException] = []
        self._inflight_bytes = 0
        self._inflight_lock = threading.Lock()
        self._reader: threading.Thread | None = None
        self._writer: threading.Thread | None = None

    # -- bounded-memory accounting ------------------------------------------
    def _track(self, nbytes: int) -> None:
        with self._inflight_lock:
            self._inflight_bytes += nbytes
            if self._inflight_bytes > self.report.peak_inflight_bytes:
                self.report.peak_inflight_bytes = self._inflight_bytes

    def _untrack(self, nbytes: int) -> None:
        with self._inflight_lock:
            self._inflight_bytes -= nbytes

    # -- reader thread ------------------------------------------------------
    def _read_loop(self, todo: list[int]) -> None:
        shards = self.source.shards()
        for i in todo:
            if self._stop.is_set():
                return
            try:
                cols = self.source.read_shard(shards[i])
                if self.columns is not None:
                    missing = [c for c in self.columns if c not in cols]
                    if missing and cols:
                        raise ScoringContractError(
                            f"shard {shards[i].target} is missing column(s) "
                            f"{missing}; pass columns=[...] that every "
                            "shard carries")
                    cols = {c: cols[c] for c in self.columns if c in cols}
                item = ("shard", i, cols, _cols_nbytes(cols))
                self._track(item[3])
            except ScoringContractError as e:
                item = ("config_error", i, e, 0)
            except Exception as e:  # noqa: BLE001 — retries exhausted
                item = ("read_error", i, e, 0)
            if not self._put(self._read_q, item):
                return
            self.m["read_queue"].set(self._read_q.qsize(), format=self.fmt)
        self._put(self._read_q, _END)

    # -- writer thread ------------------------------------------------------
    def _write_loop(self) -> None:
        open_part = None
        try:
            while True:
                cmd = self._write_q.get()
                self.m["write_queue"].set(self._write_q.qsize(),
                                          format=self.fmt)
                if cmd is _END:
                    return
                verb = cmd[0]
                if verb == "begin":
                    open_part = self.sink.begin_shard(
                        cmd[1], self.plan.host_index)
                elif verb == "write":
                    _, cols, n_valid, nbytes = cmd
                    open_part.write(cols, n_valid)
                    self._untrack(nbytes)
                elif verb == "finish":
                    _, rows, padded, quarantined = cmd
                    open_part.finish()
                    open_part = None
                    # commit accounting lives HERE, after finish() returned:
                    # the DONE marker exists, so monotonic counters can
                    # never record rows that exist in no output file
                    self.report.shards_done += 1
                    self.m["rows"].inc(rows, format=self.fmt)
                    self.m["padded"].inc(padded, format=self.fmt)
                    if quarantined:
                        self.m["quarantined_rows"].inc(quarantined,
                                                       format=self.fmt)
                    self.m["shards"].inc(format=self.fmt, status="done")
                elif verb == "abort_shard":
                    # shard-level quarantine mid-shard: discard its temp
                    # payload so nothing partial can ever commit
                    if open_part is not None:
                        open_part.abort()
                        open_part = None
                elif verb == "quarantine_shard":
                    self.sink.mark_quarantined(cmd[1], self.plan.host_index,
                                               cmd[2])
                elif verb == "quarantine_row":
                    self.sink.quarantine(self.plan.host_index, cmd[1])
        except BaseException as e:  # noqa: BLE001 — surfaced to the main loop
            self._writer_error.append(e)
            self._stop.set()
            # drain so a blocked producer wakes and sees the stop flag
            while True:
                try:
                    self._write_q.get_nowait()
                except queue.Empty:
                    break
        finally:
            if open_part is not None:
                open_part.abort()

    def _put(self, q: "queue.Queue", item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _send_write(self, cmd) -> None:
        if not self._put(self._write_q, cmd) or self._writer_error:
            raise self._writer_error[0] if self._writer_error \
                else RuntimeError("scoring writer stopped")

    # -- compute (main thread) ----------------------------------------------
    def run(self, todo: list[int]) -> None:
        if not todo:
            return
        self._reader = threading.Thread(
            target=self._read_loop, args=(todo,), daemon=True)
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._reader.start()
        self._writer.start()
        tracer = obs.get_tracer()
        shards = self.source.shards()
        while True:
            # timed get + stop check: a writer failure stops the reader
            # before its _END sentinel, so the compute loop must notice the
            # stop flag itself rather than block forever
            try:
                item = self._read_q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    raise self._writer_error[0] if self._writer_error \
                        else RuntimeError("scoring reader stopped")
                continue
            if item is _END:
                break
            kind, i, payload, nbytes = item
            self.m["read_queue"].set(self._read_q.qsize(), format=self.fmt)
            if kind == "config_error":
                raise payload
            if kind == "read_error":
                if self.on_error == "raise":
                    raise payload
                self._send_write(("quarantine_shard", i, repr(payload)))
                self.report.shards_quarantined += 1
                self.m["shards"].inc(format=self.fmt, status="quarantined")
                continue
            shard = shards[i]
            with tracer.span("scoring.shard",
                             {"shard": i, "target": shard.target,
                              "rows": _n_rows(payload)}):
                rep = self.report
                snap = (rep.rows_written, rep.rows_padded, rep.batches,
                        rep.rows_quarantined)
                try:
                    self._score_shard(i, payload)
                except ScoringContractError:
                    raise  # configuration error, never contained
                except Exception as e:  # noqa: BLE001 — shard quarantine
                    if self.on_error == "raise":
                        raise
                    # e.g. batch formation failed on this shard's columns:
                    # abort the open part (nothing partial commits), roll
                    # the report back to pre-shard, quarantine the shard
                    (rep.rows_written, rep.rows_padded, rep.batches,
                     rep.rows_quarantined) = snap
                    self._send_write(("abort_shard",))
                    self._send_write(("quarantine_shard", i,
                                      f"shard scoring failed: {e!r}"))
                    rep.shards_quarantined += 1
                    self.m["shards"].inc(format=self.fmt,
                                         status="quarantined")
            self._untrack(nbytes)
            self._progress()
        self._send_write(_END)
        self._writer.join()
        if self._writer_error:
            raise self._writer_error[0]
        # shards_done moves on the writer thread at commit time, so the
        # per-shard progress updates lag it — settle the gauges now that
        # every commit is in
        self._progress()

    def _score_shard(self, i: int, cols: dict) -> None:
        self._send_write(("begin", i))
        rows = padded = quarantined_total = 0
        for batch, n_valid, bucket, offset in iter_shard_batches(
                cols, self.plan.batch_rows, self.bucketer,
                self.plan.multiple_of, self.pad_mode):
            t0 = time.perf_counter()
            out, quarantined = self._score_batch(batch, n_valid, bucket,
                                                 shard_index=i, offset=offset)
            self.m["batch_ms"].observe((time.perf_counter() - t0) * 1e3,
                                       format=self.fmt)
            n_out = _n_rows(out) if out else 0
            if n_out:
                nbytes = _cols_nbytes(out)
                self._track(nbytes)
                self._send_write(("write", out, n_out, nbytes))
            self.report.batches += 1
            self.report.rows_written += n_out
            self.report.rows_padded += bucket - n_valid
            self.report.rows_quarantined += quarantined
            rows += n_out
            padded += bucket - n_valid
            quarantined_total += quarantined
        # the writer increments shards_done + the monotonic counters AFTER
        # open_part.finish() returns (part + DONE marker on disk) — a shard
        # that never commits, whether quarantined here or dead in the
        # writer, moves no counter
        self._send_write(("finish", rows, padded, quarantined_total))

    def _score_batch(self, batch: dict, n_valid: int, bucket: int, *,
                     shard_index: int, offset: int) -> tuple[dict, int]:
        """One fixed-shape batch through the stage. Returns (unpadded output
        columns, quarantined-row count). A batch-level exception falls back
        to row-at-a-time scoring so ONE poisoned row costs one sidecar
        record, not the scan."""
        try:
            return self._transform_cols(batch, n_valid, bucket), 0
        except ScoringContractError:
            raise
        except Exception as batch_err:  # noqa: BLE001 — contained below
            if self.on_error == "raise":
                raise
            good: list[dict] = []
            quarantined = 0
            for r in range(n_valid):
                row = {k: np.asarray(v)[r:r + 1] for k, v in batch.items()}
                try:
                    good.append(self._transform_cols(row, 1, 1))
                except Exception as row_err:  # noqa: BLE001
                    quarantined += 1
                    self._send_write(("quarantine_row", {
                        "kind": "row", "shard": shard_index,
                        "row": offset + r,
                        "error": repr(row_err),
                        "batch_error": repr(batch_err),
                        "data": _json_safe_row(batch, r)}))
            if not good:
                out: dict = {}
            else:
                out = {k: np.concatenate([g[k] for g in good])
                       for k in good[0]}
            return out, quarantined

    def _transform_cols(self, batch: dict, n_valid: int,
                        bucket: int) -> dict:
        out = self.stage.transform(DataFrame([batch])).collect()
        n_out = _n_rows(out)
        if n_out != bucket:
            raise ScoringContractError(
                f"{type(self.stage).__name__}.transform returned {n_out} "
                f"rows for a {bucket}-row batch; transform_source needs a "
                "row-preserving transformer (filters/aggregations have no "
                "exactly-once row mapping)")
        return {k: _host(v)[:n_valid] for k, v in out.items()}

    def _progress(self) -> None:
        rep = self.report
        wall = time.perf_counter() - self.t_start
        rate = rep.rows_written / wall if wall > 0 else 0.0
        self.m["rows_per_sec"].set(rate, format=self.fmt)
        assigned = max(len(self.plan.shard_indices), 1)
        seen = rep.shards_skipped + rep.shards_done + rep.shards_quarantined
        # pct is pure shard counting — no row estimate needed, so even
        # custom-reader sources (estimated_rows=None) get a progress gauge
        self.m["progress"].set(min(100.0 * seen / assigned, 100.0),
                               format=self.fmt)
        if rep.estimated_rows and self.plan.num_shards:
            host_est = rep.estimated_rows * assigned / self.plan.num_shards
            if rate > 0:
                # remaining work by UNSEEN shard fraction — resumed scans
                # skip shards whose rows this run never wrote, so
                # host_est - rows_written would never converge to 0
                remaining = host_est * max(assigned - seen, 0) / assigned
                self.m["eta"].set(remaining / rate, format=self.fmt)

    def shutdown(self) -> None:
        self._stop.set()
        for q in (self._read_q, self._write_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in (self._reader, self._writer):
            if t is not None:
                try:
                    # unblock a writer parked on an empty queue
                    self._write_q.put_nowait(_END)
                except queue.Full:
                    pass
                t.join(timeout=5.0)
        self.sink.close()


def _host(v) -> np.ndarray:
    """A stage's output column as a host array: a tensor (on any device) is
    copied here, on the compute thread, so that the writer thread handles
    numpy only."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _cols_nbytes(cols: dict) -> int:
    total = 0
    for v in cols.values():
        a = np.asarray(v)
        total += int(a.nbytes) if a.dtype != object else 64 * a.size
    return total


def _json_safe_row(batch: dict, r: int) -> dict:
    """A truncated, JSON-safe copy of one input row for the errors sidecar."""
    out = {}
    for k, v in batch.items():
        val = np.asarray(v)[r]
        if isinstance(val, np.ndarray) and val.size > 16:
            out[k] = val.ravel()[:16].tolist() + ["..."]
        else:
            out[k] = val
    return out
