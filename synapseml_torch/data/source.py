"""Sharded data sources.

Counterpart of ``synapseml_tpu/data/source.py``: a :class:`ShardedSource`
describes a dataset as a list of :class:`Shard` descriptors, and
``read_shard`` materializes ONE shard as a columnar dict, so memory is
bounded by the shard, not the dataset. Every host computes the same seeded
epoch order (``state.shard_order``) and takes the strided slice
``order[host_index::host_count]``.

A read retries transient ``OSError``/``TimeoutError`` failures under a
:class:`~synapseml_torch.core.resilience.RetryPolicy`, counting retries on
``resilience_measures("data")``.

:class:`MemorySource` (``:445-478`` there) wraps an in-memory ``DataFrame``
or column dict, so ``fit_arrays`` rides the same plane. The on-disk readers
of the JAX package (``jsonl``, ``csv``, ``npy``, ``image_dir``) and its
fault-injection hook come with a later slice (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np

from ..core.resilience import RetryPolicy, resilience_measures

__all__ = ["Shard", "ShardedSource", "MemorySource", "default_read_retry",
           "resolve_host"]


def resolve_host(host_index: int | None,
                 host_count: int | None) -> tuple[int, int]:
    """Per-host striding defaults and validation. Without a process group
    the defaults are one host: index 0 of 1."""
    host_index = 0 if host_index is None else int(host_index)
    host_count = 1 if host_count is None else int(host_count)
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} outside [0, {host_count})")
    return host_index, host_count


def default_read_retry() -> RetryPolicy:
    """Transient read failures retry on a short jittered schedule."""
    return RetryPolicy(backoffs_ms=(50, 200, 500))


@dataclasses.dataclass(frozen=True)
class Shard:
    """One independently readable slice of a dataset. ``kind`` selects the
    reader; ``start``/``stop`` are row offsets for ``memory`` shards."""

    index: int
    kind: str
    path: str            # '' for memory shards
    start: int
    stop: int

    @property
    def target(self) -> str:
        """The shard's name in spans and errors."""
        return f"{self.path}[{self.start}:{self.stop}]"


class ShardedSource:
    """A dataset as independently readable shards (see module docstring)."""

    def __init__(self, shards: Sequence[Shard],
                 reader: Callable[[Shard], dict],
                 retry_policy: RetryPolicy | None = None,
                 name: str = "source"):
        if not shards:
            raise ValueError("a ShardedSource needs at least one shard")
        self._shards = list(shards)
        self._reader = reader
        self.retry_policy = retry_policy or default_read_retry()
        self.name = name

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shards(self) -> list[Shard]:
        return list(self._shards)

    def read_shard(self, shard: Shard | int) -> dict[str, np.ndarray]:
        """Materialize one shard as a columnar dict, retried under the
        source's ``RetryPolicy``."""
        if isinstance(shard, int):
            shard = self._shards[shard]
        return self._guarded(lambda: self._reader(shard))

    def iter_shards(self):
        """Sequential (unshuffled) pass over every shard."""
        for s in self._shards:
            yield s, self.read_shard(s)

    def total_rows(self) -> int:
        """Exact row count: from the shard metadata for ``memory`` shards,
        else one full read pass. Memoized."""
        if not hasattr(self, "_total_rows"):
            if all(s.kind == "memory" for s in self._shards):
                self._total_rows = sum(s.stop - s.start for s in self._shards)
            else:
                self._total_rows = sum(_n_rows(cols) for _, cols in self.iter_shards())
        return self._total_rows

    def _guarded(self, fn: Callable[[], dict]) -> dict:
        policy = self.retry_policy
        measures = resilience_measures("data")
        for attempt in range(policy.max_attempts):
            try:
                out = fn()
                policy.on_success(first_attempt=attempt == 0)
                return out
            except (OSError, TimeoutError):
                if attempt + 1 >= policy.max_attempts or not policy.acquire_retry():
                    raise
                measures.count("retry")
                time.sleep(policy.backoff_ms(attempt) / 1000.0)
        raise AssertionError("unreachable")


def _n_rows(cols: dict) -> int:
    return len(next(iter(cols.values()))) if cols else 0


class MemorySource(ShardedSource):
    """In-memory data behind the sharded interface.

    Wraps a column dict or a ``core.DataFrame``. ``shard_rows=None`` keeps
    one shard per DataFrame partition (a dict is one shard); ``shard_rows``
    re-shards into fixed row windows, and a layout that matches another
    source's row for row gives the same batch stream under the same seed."""

    def __init__(self, data: Any, shard_rows: int | None = None,
                 retry_policy: RetryPolicy | None = None):
        from ..core.dataframe import DataFrame

        if isinstance(data, DataFrame):
            parts = [dict(p) for p in data.partitions]
        else:
            parts = [dict(data)]
        if shard_rows is not None:
            whole = {k: np.concatenate([np.asarray(p[k]) for p in parts])
                     for k in parts[0]} if parts else {}
            n = _n_rows(whole)
            parts = [{k: v[s:s + shard_rows] for k, v in whole.items()}
                     for s in range(0, max(n, 1), max(int(shard_rows), 1))]
        self._parts = [p for p in parts if _n_rows(p) > 0] or parts[:1]
        shards = [Shard(i, "memory", "", 0, _n_rows(p))
                  for i, p in enumerate(self._parts)]

        def read(shard: Shard) -> dict:
            return dict(self._parts[shard.index])

        super().__init__(shards, read, retry_policy, name="memory")
