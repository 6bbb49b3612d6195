"""Static-shape batching for training: padding buckets and a feeder.

Counterpart of ``synapseml_tpu/parallel/batching.py``: pad every minibatch
up to one of a few bucket sizes, carry a mask of the real rows, bucket
ragged token sequences, and feed batches with one batch of lookahead. The
serve-side counterpart is :mod:`synapseml_torch.core.batching`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Sequence

import numpy as np

from ..core.batching import round_up_to_multiple

__all__ = ["bucket_size", "pad_batch", "unpad", "PaddedBatch", "batches",
           "round_up_to_multiple", "pad_sequences", "DoubleBufferedFeeder"]


def bucket_size(n: int, buckets: Sequence[int] | None = None, min_bucket: int = 8) -> int:
    """Smallest bucket >= n; default buckets are powers of two."""
    if buckets:
        for b in sorted(buckets):
            if b >= n:
                return b
        raise ValueError(f"batch of {n} rows exceeds largest bucket {max(buckets)}")
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclass
class PaddedBatch:
    """Arrays padded to a static bucket + mask of real rows."""

    data: dict[str, np.ndarray]
    mask: np.ndarray  # bool[bucket]
    n_valid: int

    @property
    def n_padded(self) -> int:
        return int(self.mask.shape[0])


def pad_batch(arrays: dict[str, np.ndarray], bucket: int | None = None,
              multiple_of: int = 1, buckets: Sequence[int] | None = None) -> PaddedBatch:
    n = next(iter(arrays.values())).shape[0] if arrays else 0
    target = bucket if bucket is not None else bucket_size(n, buckets)
    target = round_up_to_multiple(target, multiple_of)
    out = {}
    for k, v in arrays.items():
        if v.dtype == object:
            raise TypeError(f"cannot pad object column {k!r}; featurize it first")
        pad = target - n
        if pad:
            out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)], axis=0)
        else:
            out[k] = v
    mask = np.zeros(target, dtype=bool)
    mask[:n] = True
    return PaddedBatch(out, mask, n)


def unpad(result, batch: PaddedBatch) -> np.ndarray:
    if hasattr(result, "detach"):
        result = result.detach().cpu().numpy()
    return np.asarray(result)[: batch.n_valid]


def batches(arrays: dict[str, np.ndarray], batch_size: int,
            multiple_of: int = 1, drop_remainder: bool = False) -> Iterator[PaddedBatch]:
    """Slice columns into fixed-size padded batches (the reference's
    ``FixedMiniBatchTransformer``)."""
    n = next(iter(arrays.values())).shape[0] if arrays else 0
    for start in range(0, n, batch_size):
        chunk = {k: v[start: start + batch_size] for k, v in arrays.items()}
        m = next(iter(chunk.values())).shape[0]
        if m < batch_size and drop_remainder:
            return
        yield pad_batch(chunk, bucket=batch_size, multiple_of=multiple_of)


def pad_sequences(seqs: Sequence[Sequence[int]], max_len: int | None = None,
                  pad_value: int = 0, multiple_of: int = 8,
                  dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Ragged token id lists -> (ids[B,L], attention_mask[B,L]) with L bucketed."""
    lengths = [min(len(s), max_len) if max_len else len(s) for s in seqs]
    L = round_up_to_multiple(max(lengths, default=1), multiple_of)
    if max_len:
        L = min(L, round_up_to_multiple(max_len, multiple_of))
    ids = np.full((len(seqs), L), pad_value, dtype=dtype)
    mask = np.zeros((len(seqs), L), dtype=dtype)
    for i, s in enumerate(seqs):
        t = list(s)[:L]
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask


class DoubleBufferedFeeder:
    """Feeding with one batch of lookahead: ``place_fn`` (a host-to-device
    copy, say) runs on the next batch before the current one is handed
    out."""

    def __init__(self, iterator: Iterator[Any], place_fn):
        self._it = iterator
        self._place = place_fn
        self._next: Any | None = None
        self._prime()

    def _prime(self):
        try:
            self._next = self._place(next(self._it))
        except StopIteration:
            self._next = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is None:
            raise StopIteration
        cur = self._next
        self._prime()
        return cur
