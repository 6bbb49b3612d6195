"""Shape-bucketed batching for the scoring path.

Counterpart of the bucketing half of ``synapseml_tpu/core/batching.py``:
:class:`ShapeBucketer` keeps the JAX package's exact batch and sequence
ladders, ``cap_for`` and ``slices`` semantics, so a variable request stream
maps onto the same handful of padded batch shapes. ``CompiledCache`` (the
per-bucket jit cache) has no counterpart yet; on the card its role goes to
per-bucket CUDA-graph capture in a later slice.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

__all__ = ["ShapeBucketer", "default_bucketer", "pad_rows", "unpad_rows",
           "round_up_to_multiple"]


def _pow2_rungs(min_bucket: int, max_bucket: int, what: str) -> list[int]:
    rungs, b = [], max(int(min_bucket), 1)
    while b <= int(max_bucket):
        rungs.append(b)
        b *= 2
    if not rungs:
        raise ValueError(f"empty pow-2 {what} ladder: min={min_bucket} > "
                         f"max={max_bucket}")
    return rungs


def _smallest_rung_geq(ladder: tuple, n: int) -> int:
    """Smallest rung >= n; n itself past the top rung (beyond-ladder sizes
    keep their exact shape)."""
    for rung in ladder:
        if rung >= n:
            return rung
    return n


def round_up_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    m = max(int(m), 1)
    return ((int(n) + m - 1) // m) * m


_round_up = round_up_to_multiple


class ShapeBucketer:
    """Pow-2 / configurable bucket ladders for the batch AND sequence dims.

    ``bucket_for(n)`` returns the smallest batch-ladder rung >= n. ``cap``
    arguments (a stage's ``batch_size``) bound memory: :meth:`slices` chunks
    at the largest rung <= cap and pads only the final partial chunk to its
    own rung. The sequence ladder (pow-2 16..4096 by default) buckets the
    token dimension the same way."""

    def __init__(self, ladder: Sequence[int] | None = None,
                 min_bucket: int = 8, max_bucket: int = 1024,
                 seq_ladder: Sequence[int] | None = None,
                 min_seq_bucket: int = 16, max_seq_bucket: int = 4096):
        if ladder is not None:
            rungs = sorted({int(b) for b in ladder})
            if not rungs or rungs[0] < 1:
                raise ValueError(f"bucket ladder must be positive ints: {ladder}")
        else:
            rungs = _pow2_rungs(min_bucket, max_bucket, "batch")
        self.ladder: tuple[int, ...] = tuple(rungs)
        if seq_ladder is not None:
            seq_rungs = sorted({int(b) for b in seq_ladder})
            if not seq_rungs or seq_rungs[0] < 1:
                raise ValueError(
                    f"seq ladder must be positive ints: {seq_ladder}")
        else:
            seq_rungs = _pow2_rungs(min_seq_bucket, max_seq_bucket, "seq")
        self.seq_ladder: tuple[int, ...] = tuple(seq_rungs)

    def __repr__(self):
        return (f"ShapeBucketer(ladder={list(self.ladder)}, "
                f"seq_ladder={list(self.seq_ladder)})")

    @property
    def max_bucket(self) -> int:
        return self.ladder[-1]

    def bucket_for(self, n: int, multiple_of: int = 1) -> int:
        """Smallest rung >= n (rounded up to ``multiple_of``). Sizes beyond
        the ladder keep their own exact shape."""
        n = max(int(n), 1)
        return _round_up(_smallest_rung_geq(self.ladder, n), multiple_of)

    def cap_for(self, max_rows: int, multiple_of: int = 1) -> int:
        """Chunking cap: the largest rung <= max_rows, except when max_rows
        sits outside the ladder: below the smallest rung it stays a hard
        memory bound, above the largest it is honored exactly."""
        cap = max(int(max_rows), 1)
        if cap <= self.ladder[-1]:
            for rung in reversed(self.ladder):
                if rung <= cap:
                    cap = rung
                    break
        return _round_up(cap, multiple_of)

    def buckets_upto(self, max_rows: int, multiple_of: int = 1) -> list[int]:
        """Every bucket :meth:`slices` can emit for a stream capped at
        ``max_rows``."""
        cap = self.cap_for(max_rows, multiple_of)
        return sorted({_round_up(r, multiple_of)
                       for r in self.ladder if r <= cap} | {cap})

    def seq_bucket_for(self, n: int, multiple_of: int = 1,
                       cap: int | None = None) -> int:
        """Smallest seq-ladder rung >= n (rounded up to ``multiple_of``);
        ``cap`` clamps at a model's max_len."""
        n = max(int(n), 1)
        bucket = _round_up(_smallest_rung_geq(self.seq_ladder, n),
                           multiple_of)
        if cap is not None:
            cap = _round_up(int(cap), multiple_of)
            if n > cap:
                raise ValueError(f"sequence length {n} exceeds cap {cap}")
            bucket = min(bucket, cap)
        return bucket

    def seq_buckets_upto(self, max_len: int, multiple_of: int = 1) -> list[int]:
        """Every bucket :meth:`seq_bucket_for` can emit for lengths up to
        ``max_len``."""
        cap = _round_up(int(max_len), multiple_of)
        out = sorted({_round_up(r, multiple_of)
                      for r in self.seq_ladder if r <= cap})
        if not out or out[-1] < cap:
            out.append(cap)
        return out

    def slices(self, n: int, max_rows: int,
               multiple_of: int = 1) -> Iterator[tuple[int, int, int]]:
        """Yield ``(start, stop, bucket)`` chunks covering ``n`` rows: full
        chunks of the ladder-aligned cap, the final partial chunk padded to
        its own (smaller) rung."""
        if n <= 0:
            return
        cap = self.cap_for(max_rows, multiple_of)
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            yield start, stop, min(self.bucket_for(stop - start, multiple_of),
                                   cap)


_DEFAULT_BUCKETER = ShapeBucketer()


def default_bucketer() -> ShapeBucketer:
    """The process-wide bucket ladder (pow-2 from 8 to 1024)."""
    return _DEFAULT_BUCKETER


def pad_rows(a: np.ndarray, bucket: int, mode: str = "zero",
             constant: float = 0) -> np.ndarray:
    """Pad the leading (row) dim up to ``bucket``. ``mode='edge'`` repeats
    the last real row; ``'constant'`` fills with ``constant``."""
    if a.dtype == object:
        raise TypeError("cannot pad an object-dtype column; featurize it "
                        "into a rectangular array first")
    n = a.shape[0]
    pad = int(bucket) - n
    if pad <= 0:
        return a
    if mode == "edge" and n:
        block = np.repeat(a[-1:], pad, axis=0)
    else:
        fill = constant if mode == "constant" else 0
        block = np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, block], axis=0)


def unpad_rows(a, n_valid: int) -> np.ndarray:
    """Strip padded rows off a host result."""
    return np.asarray(a)[: int(n_valid)]
