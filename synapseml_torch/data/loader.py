"""Streaming DataLoader: seeded shuffles, bucketed batches, async prefetch.

Counterpart of ``DataLoader`` in ``synapseml_tpu/data/loader.py:62-403``.
A background producer thread reads shards (under a ``data.prefetch``
tracer span, with the source's retry guard), assembles fixed-shape batches
through the :mod:`core.batching` bucket ladder and hands them over a
bounded queue, so the consumer never waits on an unbounded pile-up and the
producer never runs unboundedly ahead.

The batch stream is a pure function of ``(seed, epoch, shard layout)``
(:mod:`~synapseml_torch.data.state`), and every emitted batch records an
:class:`IteratorState` snapshot, so a loader built with the state after
batch *k* continues with batch *k+1*: no row replayed, none skipped.

Batches stay numpy arrays on the host: the trainer moves each one to its
device (the JAX loader's ``place_fn`` has no counterpart). The gang form,
``ElasticStreamSet``, comes with the multi-GPU slice. Observability: the
``synapseml_data_*`` series in the metrics registry (queue depth, wait and
shard-read histograms, rows and rows/s) and one span per shard read.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np

from ..core import batching as cb
from ..core import observability as obs
from .source import ShardedSource, _n_rows, resolve_host
from .state import IteratorState, row_order, shard_order

__all__ = ["DataLoader"]

_END = object()

_LOADER_METRICS = obs.HandleCache(lambda reg: {
    "queue_depth": reg.gauge(
        "synapseml_data_prefetch_queue_depth",
        "batches currently buffered ahead of the training loop", ("source",)),
    "wait_ms": reg.histogram(
        "synapseml_data_batch_wait_ms",
        "time the training loop blocked waiting for the next batch",
        ("source",)),
    "read_ms": reg.histogram(
        "synapseml_data_shard_read_ms",
        "wall time of one shard read + row-order assembly", ("source",)),
    "rows": reg.counter(
        "synapseml_data_rows_total",
        "rows emitted into training batches", ("source",)),
    "rows_per_sec": reg.gauge(
        "synapseml_data_rows_per_sec",
        "loader throughput since iteration started", ("source",)),
})


class DataLoader:
    """One-shot iterator of training batches over a :class:`ShardedSource`.

    Each batch is a dict of numpy arrays plus a ``_valid`` float32 mask
    covering bucket padding. Full batches pad to
    ``round_up(batch_size, multiple_of)``; a short epoch tail (only with
    ``drop_remainder=False``) pads to its own :class:`core.batching`
    ladder rung, so a variable tail gives at most ladder-many step shapes.

    ``host_index``/``host_count`` default to one host (0 of 1); hosts take
    disjoint strided slices of the epoch's seeded shard order.

    ``state``: resume cursor from a checkpoint (see
    :meth:`state_for_batch` / ``models.trainer.fit_source``).
    """

    def __init__(self, source: ShardedSource, batch_size: int, *,
                 seed: int = 0, epochs: int | None = None,
                 drop_remainder: bool = True, shuffle_shards: bool = True,
                 shuffle_rows: str = "full", shuffle_window: int = 4096,
                 multiple_of: int = 1, bucketer: cb.ShapeBucketer | None = None,
                 prefetch: int = 2,
                 host_index: int | None = None, host_count: int | None = None,
                 columns: list[str] | None = None,
                 state: IteratorState | None = None,
                 state_history: int = 64):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.source = source
        self.batch_size = int(batch_size)
        self.epochs = epochs
        self.drop_remainder = bool(drop_remainder)
        self.shuffle_shards = bool(shuffle_shards)
        self.shuffle_rows = shuffle_rows
        self.shuffle_window = int(shuffle_window)
        self.multiple_of = max(int(multiple_of), 1)
        self.bucketer = bucketer or cb.default_bucketer()
        self.columns = list(columns) if columns else None
        self.host_index, self.host_count = resolve_host(host_index,
                                                        host_count)

        st = state.copy() if state is not None else IteratorState(seed=int(seed))
        if state is not None and st.seed != int(seed):
            raise ValueError(f"resume state was recorded under seed {st.seed}, "
                             f"loader constructed with seed {seed}")
        if st.shard_counts is None:
            st.shard_counts = np.full(source.num_shards, -1, np.int64)
        elif st.shard_counts.shape[0] != source.num_shards:
            raise ValueError(
                f"resume state knows {st.shard_counts.shape[0]} shards but "
                f"the source has {source.num_shards} — shard layout changed "
                "since the checkpoint was written")
        self._state = st

        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(prefetch), 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # bounded per-batch state ring: a resume asks for the state of a
        # batch shortly behind the newest consumed one, so a short history
        # suffices — an unbounded dict would leak one shard_counts copy per
        # batch
        self._snapshots: dict[int, IteratorState] = {}
        self._state_history = max(int(state_history), 1)
        self._snap_lock = threading.Lock()
        self._schema_keys: tuple | None = tuple(columns) if columns else None
        self._exhausted = False
        # local stat mirrors (cheap to read in bench loops / tests)
        self._wait_s = 0.0
        self._t_start: float | None = None
        self._rows_out = 0
        self._batches_out = 0
        self._occupancy_sum = 0
        self._full_bucket = cb.round_up_to_multiple(self.batch_size,
                                                    self.multiple_of)

    # -- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        if self._thread is None:
            self._t_start = time.perf_counter()
            self._thread = threading.Thread(target=self._producer, daemon=True)
            self._thread.start()
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            iter(self)
        if self._exhausted:
            raise StopIteration
        m = _LOADER_METRICS.get()
        t0 = time.perf_counter()
        while True:
            # timed get + stop check: close() can race its _END sentinel
            # against an in-flight producer put (prefetch=1), so a blocked
            # consumer must also notice the stop flag itself
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._exhausted = True
                    raise StopIteration from None
        wait = time.perf_counter() - t0
        self._wait_s += wait
        m["wait_ms"].observe(wait * 1e3, source=self.source.name)
        self._occupancy_sum += self._q.qsize()
        m["queue_depth"].set(self._q.qsize(), source=self.source.name)
        if item is _END:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        batch, snap, n_valid = item
        with self._snap_lock:
            self._snapshots[snap.batches_emitted] = snap
            while len(self._snapshots) > self._state_history:
                self._snapshots.pop(next(iter(self._snapshots)))
        self._batches_out += 1
        self._rows_out += n_valid
        m["rows"].inc(n_valid, source=self.source.name)
        dt = max(time.perf_counter() - self._t_start, 1e-9)
        m["rows_per_sec"].set(self._rows_out / dt, source=self.source.name)
        return batch

    def close(self) -> None:
        """Stop the producer (idempotent; the thread drains on its own)."""
        self._stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:  # wake a consumer blocked in __next__'s untimed get()
            self._q.put_nowait(_END)
        except queue.Full:
            pass

    def __del__(self):  # abandoned mid-stream (e.g. fit hit max_steps)
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- checkpoint surface -------------------------------------------------
    def state_for_batch(self, batches_emitted: int) -> IteratorState | None:
        """The iterator state as of (just after) global batch
        ``batches_emitted`` — what a checkpoint taken at optimizer step N
        (one batch per step) should carry. Older snapshots are pruned."""
        with self._snap_lock:
            snap = self._snapshots.get(int(batches_emitted))
            for k in [k for k in self._snapshots if k < int(batches_emitted)]:
                del self._snapshots[k]
        return snap

    def stats(self) -> dict:
        """Local mirrors of the loader series (bench/test surface)."""
        wall = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        return {
            "batches": self._batches_out,
            "rows": self._rows_out,
            "rows_per_sec": self._rows_out / wall if wall > 0 else 0.0,
            "wait_s_total": self._wait_s,
            "stall_fraction": self._wait_s / wall if wall > 0 else 0.0,
            "mean_queue_occupancy": (self._occupancy_sum / self._batches_out
                                     if self._batches_out else 0.0),
            "queue_depth": self._q.qsize(),
        }

    # -- producer -----------------------------------------------------------
    def _conform(self, cols: dict, shard) -> dict:
        """Pin every shard to ONE schema: the ``columns`` selection, or the
        first shard's key set. Later shards' extra keys are dropped (they
        could not batch against earlier shards' arrays anyway); a MISSING
        key fails fast with the shard named — far better than a KeyError
        deep inside batch concatenation, and heterogeneous jsonl corpora
        get pointed at ``columns=[...]``."""
        if self._schema_keys is None:
            self._schema_keys = tuple(cols)
        missing = [k for k in self._schema_keys if k not in cols]
        if missing:
            raise ValueError(
                f"shard {shard.target} is missing column(s) {missing} "
                f"(stream schema {list(self._schema_keys)}); streamed "
                "batches need a uniform schema — pass columns=[...] to "
                "select the shared columns")
        return {k: cols[k] for k in self._schema_keys}

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _emit(self, buffers: list[dict], count: int, bucket: int,
              state: IteratorState) -> tuple[dict, IteratorState] | None:
        """Assemble the first ``count`` buffered rows into one padded batch +
        the post-batch state snapshot. Only the leading buffers covering
        ``count`` rows are touched — a large shard remainder is never
        re-concatenated per batch."""
        take, need = [], count
        for b in buffers:
            n = _n_rows(b)
            t = min(n, need)
            take.append({k: np.asarray(v)[:t] for k, v in b.items()}
                        if t < n else b)
            need -= t
            if need == 0:
                break
        cols = {k: (np.concatenate([np.asarray(b[k]) for b in take])
                    if len(take) > 1 else take[0][k])
                for k in take[0]}
        batch = {}
        for k, v in cols.items():
            v = np.asarray(v)
            if v.dtype == object:
                raise TypeError(
                    f"column {k!r} is object-dtype; featurize it into a "
                    "rectangular array before streaming (or pass columns=[...] "
                    "to select trainable columns)")
            batch[k] = cb.pad_rows(v[:count], bucket)
        mask = np.zeros(bucket, np.float32)
        mask[:count] = 1.0
        batch["_valid"] = mask
        return batch, state.copy(), count

    def _producer(self) -> None:
        try:
            self._produce()
        except BaseException as e:  # surface reader errors to the consumer
            self._put(e)

    def _produce(self) -> None:
        st = self._state
        m = _LOADER_METRICS.get()
        tracer = obs.get_tracer()
        bs = self.batch_size
        shards_list = self.source.shards()
        while self.epochs is None or st.epoch < self.epochs:
            order = shard_order(st.seed, st.epoch, self.source.num_shards,
                                self.shuffle_shards)
            mine = order[self.host_index::self.host_count]
            # resume fast-forward: skip whole shards already emitted this
            # epoch (their counts are known from the checkpoint), then skip
            # the consumed prefix of the boundary shard
            to_skip = st.rows_emitted
            start_pos = 0
            while start_pos < len(mine) and to_skip > 0:
                c = int(st.shard_counts[mine[start_pos]])
                if c < 0 or to_skip < c:
                    break
                to_skip -= c
                start_pos += 1
            buffers: list[dict] = []
            buffered = 0
            emitted_this_epoch = st.rows_emitted
            fresh_epoch = st.rows_emitted == 0
            puts_this_epoch = 0
            for pos in range(start_pos, len(mine)):
                if self._stop.is_set():
                    return
                si = int(mine[pos])
                shard = shards_list[si]
                t0 = time.perf_counter()
                with tracer.span("data.prefetch",
                                 {"shard": si, "target": shard.target,
                                  "epoch": st.epoch}):
                    cols = self.source.read_shard(shard)
                    if not cols:  # degenerate shard (zero rows, no schema)
                        st.shard_counts[si] = 0
                        continue
                    cols = self._conform(cols, shard)
                    n = _n_rows(cols)
                    st.shard_counts[si] = n
                    idx = row_order(st.seed, st.epoch, si, n,
                                    self.shuffle_rows, self.shuffle_window)
                    if to_skip > 0:
                        idx = idx[to_skip:]
                        to_skip = 0
                    cols = {k: np.asarray(v)[idx] for k, v in cols.items()}
                m["read_ms"].observe((time.perf_counter() - t0) * 1e3,
                                     source=self.source.name)
                if len(idx) == 0:
                    continue
                buffers.append(cols)
                buffered += len(idx)
                while buffered >= bs:
                    emitted_this_epoch += bs
                    snap = IteratorState(
                        epoch=st.epoch, rows_emitted=emitted_this_epoch,
                        batches_emitted=st.batches_emitted + 1, seed=st.seed,
                        shard_counts=st.shard_counts)
                    out = self._emit(buffers, bs, self._full_bucket, snap)
                    buffers, buffered = _carry(buffers, bs, buffered)
                    st.batches_emitted += 1
                    puts_this_epoch += 1
                    if not self._put(out):
                        return
            # epoch tail
            if buffered and not self.drop_remainder:
                bucket = min(self.bucketer.bucket_for(buffered,
                                                      self.multiple_of),
                             self._full_bucket)
                snap = IteratorState(
                    epoch=st.epoch + 1, rows_emitted=0,
                    batches_emitted=st.batches_emitted + 1, seed=st.seed,
                    shard_counts=st.shard_counts)
                out = self._emit(buffers, buffered, bucket, snap)
                st.batches_emitted += 1
                puts_this_epoch += 1
                if not self._put(out):
                    return
            if fresh_epoch and puts_this_epoch == 0:
                # A FULL epoch produced nothing — with epochs=None the loop
                # would otherwise spin re-reading the dataset forever while
                # the consumer blocks.
                if buffered == 0:
                    raise ValueError(
                        f"epoch {st.epoch} emitted no batches: this host's "
                        f"shard slice ({len(mine)} of "
                        f"{self.source.num_shards} shard(s)) produced no "
                        "rows — empty source, or more hosts than shards")
                raise ValueError(
                    f"epoch {st.epoch} emitted no batches: this host's "
                    f"shard slice holds {buffered} row(s) < "
                    f"batch_size={bs} and drop_remainder=True drops the "
                    "tail — lower batch_size or pass drop_remainder=False")
            st.epoch += 1
            st.rows_emitted = 0
        self._put(_END)


def _carry(buffers: list[dict], consumed: int, buffered: int
           ) -> tuple[list[dict], int]:
    """Drop ``consumed`` rows off the front of the buffer chain."""
    left = consumed
    out = []
    for b in buffers:
        n = _n_rows(b)
        if left >= n:
            left -= n
            continue
        out.append({k: np.asarray(v)[left:] for k, v in b.items()}
                   if left else b)
        left = 0
    return out, buffered - consumed
