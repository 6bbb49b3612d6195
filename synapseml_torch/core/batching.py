"""Shape-bucketed batching and the cache of captured callables.

Counterpart of ``synapseml_tpu/core/batching.py``:

* :class:`ShapeBucketer` keeps the JAX package's exact batch and sequence
  ladders, ``cap_for`` and ``slices`` semantics, so a variable request
  stream maps onto the same handful of padded batch shapes.
* :class:`CompiledCache` (``:250-445`` there) is the one door through which
  stage code gets a captured callable: a thread-safe LRU keyed by
  ``(fn_id, instance, shape, dtype)``, with the same ``capacity``, the same
  hit / miss / eviction counters on the metrics registry, and the first
  call of each miss under a ``compile`` span whose wall time lands in
  ``synapseml_compile_trace_ms{fn=...}``. Where the JAX package builds a
  ``jax.jit`` wrapper, the port's builders return a runner whose first call
  captures a CUDA graph (``models/trainer.py``'s scanned step), so that
  histogram times the capture. The AOT tier of the deploy plane
  (``install_aot_provider``, ``set_capture``) is refused until that plane
  is ported.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from . import observability as obs

__all__ = ["ShapeBucketer", "default_bucketer", "pad_rows", "unpad_rows",
           "round_up_to_multiple", "CompiledCache", "get_compiled_cache",
           "instance_token", "invalidate_token"]

_AOT = "ROADMAP.md queue A item 10 (the deploy plane's AOT tier)"

_CACHE_METRICS = obs.HandleCache(lambda reg: {
    "hits": reg.counter(
        "synapseml_compile_cache_hits_total",
        "CompiledCache lookups served by an existing executable", ("fn",)),
    "misses": reg.counter(
        "synapseml_compile_cache_misses_total",
        "CompiledCache lookups that built a new executable", ("fn",)),
    "evictions": reg.counter(
        "synapseml_compile_cache_evictions_total",
        "CompiledCache LRU evictions", ("fn",)),
    "trace_ms": reg.histogram(
        "synapseml_compile_trace_ms",
        "wall time of the first (tracing/compiling) call of a cache miss",
        ("fn",)),
})


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


class CompiledCache:
    """Thread-safe LRU of built callables keyed by ``(fn_id, instance,
    shape, dtype)``.

    ``get`` returns the cached callable or calls ``build`` for a new one.
    The miss's first call runs under a ``compile`` span, and its wall time
    lands in ``synapseml_compile_trace_ms{fn=...}``: that call is where a
    graph is captured. Past ``capacity`` entries the least recently used is
    dropped (and with it its graph and memory pool, once no caller holds
    it)."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Callable]" = OrderedDict()
        # local mirrors of the registry counters
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.trace_ms_total = 0.0  # wall time of the misses' first calls

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._entries),
                    "trace_ms_total": self.trace_ms_total}

    def install_aot_provider(self, provider) -> None:
        raise NotImplementedError(f"the AOT tier of CompiledCache is not ported to "
                                  f"synapseml_torch yet: {_AOT}")

    def set_capture(self, capture) -> None:
        raise NotImplementedError(f"the AOT capture of CompiledCache is not ported to "
                                  f"synapseml_torch yet: {_AOT}")

    def miss_count(self, fn_id: str) -> float:
        """Registry-backed miss count of ``fn_id``."""
        return _CACHE_METRICS.get()["misses"].labels(fn=fn_id).value

    def get(self, fn_id: str, shape: tuple, build: Callable[[], Callable],
            *, instance: Any = None, dtype: Any = None) -> Callable:
        """The one acquisition door. ``fn_id`` labels the metric series;
        ``shape`` is the static shape key; ``instance`` tells owners apart
        (use :func:`instance_token`, not ``id(obj)``, which is reused after
        GC); ``dtype`` joins the key for dtype-polymorphic functions."""
        key = (fn_id, instance, tuple(shape), dtype)
        m = _CACHE_METRICS.get()
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                m["hits"].inc(fn=fn_id)
                return fn
        fn = self._traced_first_call(build(), fn_id, key)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:  # a concurrent build won
                self._entries.move_to_end(key)
                self.hits += 1
                m["hits"].inc(fn=fn_id)
                return existing
            self._entries[key] = fn
            self.misses += 1
            m["misses"].inc(fn=fn_id)
            while len(self._entries) > self.capacity:
                evicted_key, _ = self._entries.popitem(last=False)
                self.evictions += 1
                # counted against the evicted entry's function: its next
                # call pays the rebuild
                m["evictions"].inc(fn=evicted_key[0])
        return fn

    def _traced_first_call(self, fn: Callable, fn_id: str, key: tuple) -> Callable:
        """``fn`` whose first call runs under a ``compile`` span and the
        trace-time histogram; later calls pay one check."""
        state = {"first": True}
        first_lock = threading.Lock()

        def wrapper(*args, **kwargs):
            if state["first"]:
                with first_lock:
                    if state["first"]:
                        t0 = time.perf_counter()
                        with obs.get_tracer().span("compile", {"fn": fn_id,
                                                               "shape": str(key[2])}):
                            out = fn(*args, **kwargs)
                        dur_ms = (time.perf_counter() - t0) * 1e3
                        _CACHE_METRICS.get()["trace_ms"].observe(dur_ms, fn=fn_id)
                        with self._lock:
                            self.trace_ms_total += dur_ms
                        state["first"] = False
                        return out
            return fn(*args, **kwargs)

        return wrapper

    def evict_instance(self, instance: Any) -> int:
        """Drop every entry keyed to ``instance``; returns how many."""
        m = _CACHE_METRICS.get()
        with self._lock:
            doomed = [k for k in self._entries if k[1] == instance]
            for k in doomed:
                del self._entries[k]
                self.evictions += 1
                m["evictions"].inc(fn=k[0])
        return len(doomed)


_DEFAULT_CACHE = CompiledCache()
_DEFAULT_LOCK = threading.Lock()
_TOKEN_SLOT = "_compiled_cache_token"


def get_compiled_cache() -> CompiledCache:
    """The process-wide cache."""
    return _DEFAULT_CACHE


def instance_token(obj: Any) -> str:
    """A random token for ``obj``, minted once under a lock, for
    :class:`CompiledCache` keys: unlike ``id(obj)`` it is never reused
    after GC."""
    tok = obj.__dict__.get(_TOKEN_SLOT)
    if tok is None:
        with _DEFAULT_LOCK:
            tok = obj.__dict__.get(_TOKEN_SLOT)
            if tok is None:
                tok = obj.__dict__[_TOKEN_SLOT] = uuid.uuid4().hex
    return tok


def invalidate_token(obj: Any) -> None:
    """Drop ``obj``'s token, so that the next :func:`instance_token` mints a
    fresh one, and evict the old token's entries from the default cache (a
    dead configuration's callables would pin its weights otherwise)."""
    tok = obj.__dict__.pop(_TOKEN_SLOT, None)
    if tok is not None:
        get_compiled_cache().evict_instance(tok)
