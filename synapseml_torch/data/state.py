"""Checkpointable iterator state and the deterministic order functions.

Counterpart of ``synapseml_tpu/data/state.py:28-125``, copied as it is so
the port emits the same batch streams: the stream is a pure function of
``(seed, epoch, shard layout, cursor)``. The shard order of an epoch is
``shard_order(seed, epoch, ...)``, the row order inside a shard
``row_order(seed, epoch, shard_index, ...)`` (numpy generators seeded by
those integers). A mid-epoch resume needs only the four cursors of
:class:`IteratorState`: regenerate the epoch's orders, skip whole shards
whose row counts fit under ``rows_emitted``, skip the rest inside the
boundary shard, and continue, with no row replayed or skipped.
``ElasticPlan`` (the N->M gang redistribution) comes with the multi-GPU
slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["IteratorState", "shard_order", "row_order"]


def shard_order(seed: int, epoch: int, n_shards: int,
                shuffle: bool = True) -> np.ndarray:
    """The epoch's global shard visit order (identical on every host; hosts
    then take strided disjoint slices of it)."""
    if not shuffle:
        return np.arange(n_shards, dtype=np.int64)
    return np.random.default_rng([int(seed), int(epoch), 0x5AD5]).permutation(
        n_shards).astype(np.int64)


def _window_shuffle(n: int, window: int, rng: np.random.Generator) -> np.ndarray:
    """Streaming window shuffle: a ``window``-slot buffer over the sequential
    row stream; each emit draws a random slot and refills it with the next
    row. Bounded shuffling locality (the out-of-core discipline) while still
    a pure function of the rng seed."""
    out = np.empty(n, dtype=np.int64)
    window = max(int(window), 1)
    buf = list(range(min(window, n)))
    nxt = len(buf)
    draws = rng.integers(0, window, size=n)  # one block of randomness up front
    for j in range(n):
        r = int(draws[j]) % len(buf)
        out[j] = buf[r]
        if nxt < n:
            buf[r] = nxt
            nxt += 1
        else:
            buf[r] = buf[-1]
            buf.pop()
    return out


def row_order(seed: int, epoch: int, shard_index: int, n_rows: int,
              mode: str = "full", window: int = 4096) -> np.ndarray:
    """Within-shard row visit order for one (seed, epoch, shard).

    ``mode``: 'full' — full permutation (shards are memory-bounded, so this
    is the default); 'window' — streaming window shuffle of locality
    ``window``; 'none' — sequential.
    """
    if n_rows <= 0:
        return np.empty(0, dtype=np.int64)
    if mode == "none":
        return np.arange(n_rows, dtype=np.int64)
    rng = np.random.default_rng([int(seed), int(epoch), int(shard_index),
                                 0x12D7])
    if mode == "full":
        return rng.permutation(n_rows).astype(np.int64)
    if mode == "window":
        return _window_shuffle(n_rows, window, rng)
    raise ValueError(f"shuffle_rows must be 'full', 'window' or 'none', "
                     f"got {mode!r}")


@dataclasses.dataclass
class IteratorState:
    """Where a :class:`~synapseml_torch.data.loader.DataLoader` stands, as of
    the last EMITTED batch (prefetched-but-unconsumed work is excluded — a
    restore never replays or skips rows the training loop actually saw)."""

    epoch: int = 0
    rows_emitted: int = 0       # rows in emitted batches, current epoch, this host
    batches_emitted: int = 0    # global batch counter (across epochs)
    seed: int = 0
    # (n_shards,) row count per shard once discovered; -1 = not yet read.
    # Counts are a property of the SOURCE (identical every epoch), so a
    # resume can position inside the epoch without re-reading skipped shards.
    shard_counts: np.ndarray | None = None

    def copy(self) -> "IteratorState":
        return IteratorState(
            epoch=self.epoch, rows_emitted=self.rows_emitted,
            batches_emitted=self.batches_emitted, seed=self.seed,
            shard_counts=None if self.shard_counts is None
            else self.shard_counts.copy())

    def to_tree(self) -> dict:
        """A dict of numpy integers (what a checkpoint would carry)."""
        return {
            "epoch": np.int64(self.epoch),
            "rows_emitted": np.int64(self.rows_emitted),
            "batches_emitted": np.int64(self.batches_emitted),
            "seed": np.int64(self.seed),
            "shard_counts": (np.asarray(self.shard_counts, np.int64)
                             if self.shard_counts is not None
                             else np.full(0, -1, np.int64)),
        }

    @classmethod
    def from_tree(cls, tree: dict) -> "IteratorState":
        counts = np.asarray(tree["shard_counts"], np.int64)
        return cls(epoch=int(tree["epoch"]),
                   rows_emitted=int(tree["rows_emitted"]),
                   batches_emitted=int(tree["batches_emitted"]),
                   seed=int(tree["seed"]),
                   shard_counts=counts if counts.size else None)
