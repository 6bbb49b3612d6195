"""Sharded scoring sinks with exactly-once semantics.

Counterpart of ``synapseml_tpu/scoring/sink.py``: the same layout, bytes and
rules. One directory, shared by every host of a scan::

    part-00042.jsonl            # or part-00042.<col>.npy per column
    part-00042.DONE             # JSON: rows, files, host, quarantined
    cursor-00000.jsonl          # append-only per-host completion log
    errors-00000.jsonl          # per-host quarantine sidecar (poisoned rows)
    _SUCCESS                    # whole-scan marker, all shards DONE

* **Atomic parts**: every payload file streams to a same-directory temp and
  appears by ``os.replace`` (``io.files``'s streamed writers), so a killed
  scan never leaves a torn part under a committed name.
* **DONE markers**: a shard is emitted only when its ``.DONE`` marker exists
  and every payload file it lists is present; the marker is written after
  the payload renames (``registry.store.atomic_write_bytes``).
* **Append-only cursor**: each host appends one fsynced record per finished
  shard, the ordered audit trail beside the markers, which are the resume
  ground truth (:meth:`ScoreSink.completed`).

A resume skips the shards whose markers are complete and reruns the rest;
part content is a function of the shard, so the output is byte-identical
to an uninterrupted run's.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import time
from typing import Any, Sequence

import numpy as np

from ..io import files as iofiles
from ..registry.store import atomic_write_bytes

__all__ = ["ScoreSink", "JsonlSink", "NpySink", "open_sink",
           "SUCCESS_MARKER"]

SUCCESS_MARKER = "_SUCCESS"
_PART_PREFIX = "part-"
_DONE_SUFFIX = ".DONE"


class _OpenPart:
    """One in-flight shard's payload writers; produced by
    :meth:`ScoreSink.begin_shard`, driven by the runner's writer thread."""

    def __init__(self, sink: "ScoreSink", shard_index: int, host_index: int):
        self.sink = sink
        self.shard_index = int(shard_index)
        self.host_index = int(host_index)
        self.rows = 0
        self._writers = sink._open_writers(shard_index)

    def write(self, cols: dict, n_valid: int) -> None:
        """Append ``n_valid`` already-unpadded rows of one scored batch."""
        self.sink._write_chunk(self._writers, cols, int(n_valid))
        self.rows += int(n_valid)

    def finish(self, meta: dict | None = None) -> dict:
        """Commit payload file(s), then the DONE marker, then the cursor
        record — strictly in that order, so every observable completion
        state is recoverable."""
        files = [os.path.basename(w.commit()) for w in self._writers]
        record = {"shard": self.shard_index, "rows": self.rows,
                  "files": files, "host": self.host_index,
                  "quarantined": False}
        if meta:
            record.update(meta)
        self.sink._mark_done(record)
        return record

    def abort(self) -> None:
        for w in self._writers:
            w.abort()


class ScoreSink:
    """Base sharded sink: directory layout, DONE markers, cursor, errors
    sidecar, ``_SUCCESS``. Subclasses provide the payload format."""

    format = "none"

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self._cursor_f = None
        self._cursor_host = None
        self._errors_f = None
        self._errors_host = None

    # -- payload hooks (subclass) -------------------------------------------
    def _open_writers(self, shard_index: int) -> Sequence[Any]:
        raise NotImplementedError

    def _write_chunk(self, writers: Sequence[Any], cols: dict,
                     n_valid: int) -> None:
        raise NotImplementedError

    # -- naming -------------------------------------------------------------
    def part_stem(self, shard_index: int) -> str:
        return f"{_PART_PREFIX}{int(shard_index):05d}"

    def done_path(self, shard_index: int) -> str:
        return os.path.join(self.path,
                            self.part_stem(shard_index) + _DONE_SUFFIX)

    # -- lifecycle ----------------------------------------------------------
    def begin_shard(self, shard_index: int, host_index: int = 0) -> _OpenPart:
        """Open the shard's payload writers. Crash leftovers from a
        previous attempt at THIS shard (temp files named under its stem)
        are swept first — a shard is owned by exactly one host, and one
        host runs its shards sequentially, so nothing live can match. The
        glob is anchored at the stem boundary (payload names always put a
        ``.`` after the stem): ``part-12345*`` would also match another
        shard's live ``part-123456.*`` temp once stems outgrow 5 digits."""
        for stale in _glob.glob(os.path.join(
                self.path, self.part_stem(shard_index) + ".*.tmp.*")):
            try:
                os.unlink(stale)
            except OSError:
                pass
        return _OpenPart(self, shard_index, host_index)

    def mark_quarantined(self, shard_index: int, host_index: int,
                         error: str) -> dict:
        """Record a poisoned SHARD: zero-row DONE marker (so the scan
        completes and a resume does not retry it forever) + an errors-
        sidecar record. Re-score deliberately by deleting the marker."""
        record = {"shard": int(shard_index), "rows": 0, "files": [],
                  "host": int(host_index), "quarantined": True,
                  "error": str(error)}
        self._mark_done(record)
        self.quarantine(host_index, {"kind": "shard", "shard": int(shard_index),
                                     "error": str(error)})
        return record

    def _mark_done(self, record: dict) -> None:
        atomic_write_bytes(self.done_path(record["shard"]),
                           json.dumps(record, sort_keys=True).encode())
        self._append_cursor(record)

    def _append_cursor(self, record: dict) -> None:
        host = int(record.get("host", 0))
        if self._cursor_f is None or self._cursor_host != host:
            if self._cursor_f is not None:
                self._cursor_f.close()
            self._cursor_f = open(os.path.join(
                self.path, f"cursor-{host:05d}.jsonl"), "a")
            self._cursor_host = host
        self._cursor_f.write(json.dumps(
            {**record, "ts": time.time()}, sort_keys=True) + "\n")
        self._cursor_f.flush()
        os.fsync(self._cursor_f.fileno())

    def quarantine(self, host_index: int, record: dict) -> None:
        """Append one poisoned row/shard record to this host's errors
        sidecar (plain appended jsonl — the sidecar is diagnostic, not part
        of the exactly-once output set, so records flush per append but
        fsync only on close: a 1000-row poisoned batch must not turn into
        1000 blocking fsyncs on the writer thread)."""
        host = int(host_index)
        if self._errors_f is None or self._errors_host != host:
            if self._errors_f is not None:
                self._errors_f.close()
            self._errors_f = open(os.path.join(
                self.path, f"errors-{host:05d}.jsonl"), "a")
            self._errors_host = host
        self._errors_f.write(json.dumps(record, sort_keys=True,
                                        default=iofiles.json_default) + "\n")
        self._errors_f.flush()

    def close(self) -> None:
        if self._cursor_f is not None:
            self._cursor_f.close()
            self._cursor_f = None
        if self._errors_f is not None:
            try:
                os.fsync(self._errors_f.fileno())
            except OSError:
                pass
            self._errors_f.close()
            self._errors_f = None

    def __enter__(self) -> "ScoreSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resume / inspection ------------------------------------------------
    def completed(self) -> dict[int, dict]:
        """shard_index -> DONE record, for every COMPLETE shard: marker
        present and every payload file it lists still on disk (the
        checkpoint completeness rule — a marker beside a vanished payload
        is not a completion)."""
        out: dict[int, dict] = {}
        for marker in _glob.glob(os.path.join(
                self.path, _PART_PREFIX + "*" + _DONE_SUFFIX)):
            try:
                with open(marker) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # torn/foreign marker: treat as incomplete
            if not isinstance(rec, dict) or not isinstance(
                    rec.get("files"), list):
                continue  # valid JSON but not OUR record shape: foreign
            try:
                shard = int(rec["shard"])
            except (KeyError, TypeError, ValueError):
                continue
            if all(os.path.exists(os.path.join(self.path, name))
                   for name in rec["files"]):
                out[shard] = rec
        return out

    @staticmethod
    def _read_jsonl_tolerant(path: str) -> list[dict]:
        """Appended diagnostic jsonl with a possibly-torn final line (a
        host killed mid-append): return the intact prefix — the audit
        trail must stay readable in exactly the crash it explains."""
        out = []
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    out.append(json.loads(ln))
                except json.JSONDecodeError:
                    continue
        return out

    def cursor_records(self) -> list[dict]:
        """Every host's cursor records, in (host, append) order."""
        return [r for p in sorted(_glob.glob(
            os.path.join(self.path, "cursor-*.jsonl")))
            for r in self._read_jsonl_tolerant(p)]

    def error_records(self) -> list[dict]:
        return [r for p in sorted(_glob.glob(
            os.path.join(self.path, "errors-*.jsonl")))
            for r in self._read_jsonl_tolerant(p)]

    def finalize(self, num_shards: int, done: dict | None = None) -> bool:
        """Write ``_SUCCESS`` iff every one of the scan's ``num_shards``
        shards is complete (whichever host finishes last wins the write —
        it is idempotent). Returns scan completeness. ``done`` accepts a
        just-computed :meth:`completed` dict so end-of-scan callers don't
        re-glob + re-parse every marker."""
        done = self.completed() if done is None else done
        complete = all(i in done for i in range(int(num_shards)))
        if complete:
            atomic_write_bytes(
                os.path.join(self.path, SUCCESS_MARKER),
                json.dumps({"shards": int(num_shards),
                            "rows": sum(r["rows"] for r in done.values()),
                            "quarantined_shards": sum(
                                1 for r in done.values()
                                if r.get("quarantined"))},
                           sort_keys=True).encode())
        return complete

    def is_complete(self) -> bool:
        return os.path.exists(os.path.join(self.path, SUCCESS_MARKER))

    def part_files(self, done: dict | None = None) -> list[str]:
        """Completed payload files in shard order (the scan's output set).
        ``done`` as in :meth:`finalize`."""
        done = self.completed() if done is None else done
        return [os.path.join(self.path, name)
                for i in sorted(done) for name in done[i]["files"]]


class JsonlSink(ScoreSink):
    """One ``part-NNNNN.jsonl`` per input shard. ``columns=None`` writes
    every output column; pass a list to project (e.g. drop the raw input
    features from an embedding backfill)."""

    format = "jsonl"

    def __init__(self, path: str, columns: Sequence[str] | None = None):
        super().__init__(path)
        self.columns = list(columns) if columns else None

    def _open_writers(self, shard_index: int):
        return [iofiles.jsonl_writer(os.path.join(
            self.path, self.part_stem(shard_index) + ".jsonl"))]

    def _write_chunk(self, writers, cols: dict, n_valid: int) -> None:
        names = self.columns or list(cols.keys())
        missing = [c for c in names if c not in cols]
        if missing:
            raise ValueError(f"sink columns {missing} not in scored batch "
                             f"(has {sorted(cols)})")
        writers[0].write_columns({c: cols[c] for c in names}, n_valid)

    def collect_rows(self) -> list[dict]:
        """Read every completed part back, in shard order (test/bench
        surface — NOT a bulk API; the output of a real scan is consumed
        file-by-file)."""
        rows: list[dict] = []
        for p in self.part_files():
            with open(p) as f:
                rows += [iofiles.loads_jsonl_line(ln, p, k + 1)
                         for k, ln in enumerate(f) if ln.strip()]
        return rows


class NpySink(ScoreSink):
    """One ``part-NNNNN.<col>.npy`` per selected column per shard — the
    embedding-corpus layout (rectangular numeric outputs, zero JSON
    overhead)."""

    format = "npy"

    def __init__(self, path: str, columns: Sequence[str]):
        super().__init__(path)
        if not columns:
            raise ValueError("NpySink needs an explicit column list "
                             "(e.g. columns=['prediction'])")
        self.columns = list(columns)

    def _open_writers(self, shard_index: int):
        stem = self.part_stem(shard_index)
        return [iofiles.npy_writer(os.path.join(
            self.path, f"{stem}.{c}.npy")) for c in self.columns]

    def _write_chunk(self, writers, cols: dict, n_valid: int) -> None:
        for w, c in zip(writers, self.columns):
            if c not in cols:
                raise ValueError(f"sink column {c!r} not in scored batch "
                                 f"(has {sorted(cols)})")
            w.append(np.asarray(cols[c])[:n_valid])

    def collect_column(self, column: str) -> np.ndarray:
        """Concatenate one column across completed parts, shard order.
        Zero-row parts (a shard whose every row quarantined) carry no
        dtype/trailing-shape information — the streamed writer stamps them
        ``(0,)`` float64 — so they are skipped rather than poisoning the
        concatenation."""
        done = self.completed()
        # exact payload names — a suffix match would also collect
        # 'raw.a' parts when asked for column 'a'
        chunks = [np.load(os.path.join(self.path, name))
                  for i in sorted(done) for name in done[i]["files"]
                  if name == f"{self.part_stem(i)}.{column}.npy"]
        chunks = [c for c in chunks if c.shape[0]]
        if not chunks:
            return np.empty(0)
        return np.concatenate(chunks, axis=0)


def open_sink(path: str, format: str = "jsonl",
              columns: Sequence[str] | None = None) -> ScoreSink:
    """Sink factory: ``format`` is ``'jsonl'`` or ``'npy'``."""
    if format == "jsonl":
        return JsonlSink(path, columns=columns)
    if format == "npy":
        if columns is None:
            raise ValueError("format='npy' requires columns=[...]")
        return NpySink(path, columns=columns)
    raise ValueError(f"unknown sink format {format!r}; "
                     "one of ('jsonl', 'npy')")
