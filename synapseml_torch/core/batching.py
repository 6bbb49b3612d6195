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
  histogram times the capture. The deploy plane's second tier is kept
  as the JAX one is, mechanism-agnostic: ``install_aot_provider`` adds a
  provider whose ``lookup(fn_id, instance, shape, dtype)`` a miss consults
  before building (a hit counts in ``aot_hits``, not as a miss), and
  ``set_capture`` installs a publish-time recorder whose ``wrap(key,
  built)`` sees every build. The port's registry
  (``registry/aot.py``) records no executables, so on the card no provider
  is installed and every miss builds.
* :func:`release_executables` evicts a replaced pipeline's entries on a
  hot swap; a batch still running on the old pipeline holds its callable
  and finishes with it.
* ``set_default_bucketer`` and ``reset_compiled_cache`` swap the
  process-wide ladder and cache, as the JAX ones do.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from . import observability as obs

__all__ = ["ShapeBucketer", "default_bucketer", "set_default_bucketer", "pad_rows",
           "unpad_rows", "round_up_to_multiple", "CompiledCache", "get_compiled_cache",
           "reset_compiled_cache", "instance_token", "invalidate_token",
           "release_executables"]

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
    "aot_hits": reg.counter(
        "synapseml_compile_cache_aot_hits_total",
        "CompiledCache misses served by an installed AOT provider", ("fn",)),
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
_DEFAULT_LOCK = threading.Lock()


def default_bucketer() -> ShapeBucketer:
    """The process-wide bucket ladder (pow-2 from 8 to 1024 unless
    replaced)."""
    return _DEFAULT_BUCKETER


def set_default_bucketer(bucketer: ShapeBucketer) -> ShapeBucketer:
    """Swap the process-wide ladder (serving config, tests); returns the
    previous one so that callers can restore it."""
    global _DEFAULT_BUCKETER
    with _DEFAULT_LOCK:
        previous = _DEFAULT_BUCKETER
        _DEFAULT_BUCKETER = bucketer
        return previous


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
        # the deploy plane's second tier: providers a miss consults before
        # building, and the publish-time recorder of builds
        self._aot_providers: list = []
        self._capture = None
        # local mirrors of the registry counters
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.aot_hits = 0
        self.trace_ms_total = 0.0  # wall time of the misses' first calls

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._entries),
                    "aot_hits": self.aot_hits,
                    "trace_ms_total": self.trace_ms_total}

    def install_aot_provider(self, provider) -> None:
        """Add a lookup tier: misses consult ``provider.lookup(fn_id,
        instance, shape, dtype)`` before building."""
        with self._lock:
            if provider not in self._aot_providers:
                self._aot_providers.append(provider)

    def remove_aot_provider(self, provider) -> None:
        """Detach a swapped-out artifact's tier (the entries it served stay
        until they are evicted with their pipeline's tokens)."""
        with self._lock:
            try:
                self._aot_providers.remove(provider)
            except ValueError:
                pass

    def set_capture(self, capture) -> None:
        """Install (or clear, with None) the publish-time recorder: every
        miss's built callable goes through ``capture.wrap(key, built)``."""
        with self._lock:
            self._capture = capture

    def _insert(self, key: tuple, fn: Callable, m: dict) -> None:
        """Put ``fn`` under ``key`` and evict past ``capacity`` (lock held)."""
        self._entries[key] = fn
        while len(self._entries) > self.capacity:
            evicted_key, _ = self._entries.popitem(last=False)
            self.evictions += 1
            # counted against the evicted entry's function: its next call
            # pays the rebuild
            m["evictions"].inc(fn=evicted_key[0])

    def _hit_existing(self, key: tuple, fn_id: str, m: dict):
        """The entry under ``key`` counted as a hit, or None (lock held)."""
        fn = self._entries.get(key)
        if fn is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            m["hits"].inc(fn=fn_id)
        return fn

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
            fn = self._hit_existing(key, fn_id, m)
            if fn is not None:
                return fn
            providers = tuple(self._aot_providers)
            capture = self._capture
        # the second tier: a provider's hit is ready to run and is not a miss
        for provider in providers:
            try:
                fn = provider.lookup(fn_id, instance, key[2], dtype)
            except Exception:  # noqa: BLE001 - a broken provider demotes to a build
                fn = None
            if fn is not None:
                with self._lock:
                    existing = self._hit_existing(key, fn_id, m)
                    if existing is not None:
                        return existing
                    self._insert(key, fn, m)
                    self.aot_hits += 1
                    m["aot_hits"].inc(fn=fn_id)
                return fn
        built = build()
        if capture is not None:
            built = capture.wrap(key, built)
        fn = self._traced_first_call(built, fn_id, key)
        with self._lock:
            existing = self._hit_existing(key, fn_id, m)  # a concurrent build won
            if existing is not None:
                return existing
            self._insert(key, fn, m)
            self.misses += 1
            m["misses"].inc(fn=fn_id)
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
_TOKEN_SLOT = "_compiled_cache_token"


def get_compiled_cache() -> CompiledCache:
    """The process-wide cache."""
    return _DEFAULT_CACHE


def reset_compiled_cache(capacity: int = 128) -> CompiledCache:
    """A fresh process-wide cache (tests). The registry's counters are not
    reset: ``observability.reset_registry()`` does that."""
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        _DEFAULT_CACHE = CompiledCache(capacity)
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


def stage_tree(stage: Any) -> list:
    """``stage`` and its nested stages (the ``stages`` Param of a Pipeline
    or PipelineModel), root first, each once, in order."""
    seen: set[int] = set()
    out = []

    def walk(obj):
        if obj is None or id(obj) in seen:
            return
        seen.add(id(obj))
        out.append(obj)
        getter = getattr(obj, "get", None)
        if callable(getter):
            try:
                children = getter("stages")
            except Exception:  # noqa: BLE001 - not every stage has 'stages'
                return
            if isinstance(children, (list, tuple)):
                for child in children:
                    walk(child)

    walk(stage)
    return out


def release_executables(stage: Any) -> None:
    """Invalidate the tokens of ``stage`` and of its nested stages,
    evicting their cached callables: the hot-swap path calls it on the
    replaced pipeline, so that a serving process does not keep one dead
    model's weights a swap. A caller that already holds a callable keeps
    running it."""
    for obj in stage_tree(stage):
        invalidate_token(obj)
