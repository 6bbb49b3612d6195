"""Bulk-scoring scan planning: per-host shard assignment and batch formation.

Counterpart of ``synapseml_tpu/scoring/planner.py``. Every host derives the
same plan: the shard list in source order, each host taking the strided
slice ``range(num_shards)[host_index::host_count]`` (``data.DataLoader``'s
per-host striding without its shuffle: a scan is order-deterministic, so a
kill and resume gives byte-identical output). The slices are a disjoint
exact cover of the shards. Without a process group the defaults are one
host, index 0 of 1 (``data.source.resolve_host``).

Batches ride the ``core.batching`` ladder: a shard's rows chunk at the
largest rung <= ``batch_rows`` and the last partial chunk pads to its own
rung (``ShapeBucketer.slices``), so a scan presents at most
:attr:`ScoringPlan.buckets` batch shapes to a stage, and a stage that keys
its ``CompiledCache`` callables by shape builds at most that many.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core import batching as cb
from ..data.source import ShardedSource, _n_rows, resolve_host

__all__ = ["ScoringPlan", "assign_shards", "plan_scan", "iter_shard_batches"]


def assign_shards(num_shards: int, host_index: int | None = None,
                  host_count: int | None = None) -> list[int]:
    """This host's shard indices, ``range(num_shards)[host_index::host_count]``:
    across hosts, a disjoint exact cover of the shards."""
    host_index, host_count = resolve_host(host_index, host_count)
    return list(range(int(num_shards)))[host_index::host_count]


@dataclasses.dataclass(frozen=True)
class ScoringPlan:
    """One host's share of a scan and the closed set of batch shapes it can
    emit (the warmup set and the compile bound)."""

    num_shards: int                 # whole dataset, all hosts
    shard_indices: tuple[int, ...]  # this host's assignment, scan order
    host_index: int
    host_count: int
    batch_rows: int                 # chunking cap (ladder-aligned by slices)
    multiple_of: int
    buckets: tuple[int, ...]        # every padded batch size the scan emits


def plan_scan(source: ShardedSource, batch_rows: int = 256,
              bucketer: cb.ShapeBucketer | None = None,
              multiple_of: int = 1, host_index: int | None = None,
              host_count: int | None = None) -> ScoringPlan:
    """This host's :class:`ScoringPlan` for ``source``."""
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    b = bucketer or cb.default_bucketer()
    host_index, host_count = resolve_host(host_index, host_count)
    mine = assign_shards(source.num_shards, host_index, host_count)
    return ScoringPlan(
        num_shards=source.num_shards, shard_indices=tuple(mine),
        host_index=host_index, host_count=host_count,
        batch_rows=int(batch_rows), multiple_of=max(int(multiple_of), 1),
        buckets=tuple(b.buckets_upto(batch_rows, multiple_of)))


def _pad_any(a: np.ndarray, bucket: int, mode: str) -> np.ndarray:
    """``cb.pad_rows`` for any column: string and object columns (ids, urls,
    heterogeneous passthrough) pad by repeating their last row. Padded rows
    never reach the sink."""
    if a.dtype == object or a.dtype.kind in "US":
        n = a.shape[0]
        pad = int(bucket) - n
        if pad <= 0 or not n:
            return a
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
    return cb.pad_rows(a, bucket, mode=mode)


def iter_shard_batches(cols: dict, batch_rows: int,
                       bucketer: cb.ShapeBucketer | None = None,
                       multiple_of: int = 1, pad_mode: str = "edge"
                       ) -> Iterator[tuple[dict, int, int, int]]:
    """One shard's columns as fixed-shape batches, ``(padded_batch, n_valid,
    bucket, row_offset)`` each: full chunks at the ladder-aligned cap, the
    tail padded to its own rung (``pad_mode='edge'`` repeats the last real
    row). The runner strips the padded rows from the stage's output."""
    b = bucketer or cb.default_bucketer()
    n = _n_rows(cols)
    for start, stop, bucket in b.slices(n, batch_rows, multiple_of):
        batch = {k: _pad_any(np.asarray(v)[start:stop], bucket, pad_mode)
                 for k, v in cols.items()}
        yield batch, stop - start, bucket, start
