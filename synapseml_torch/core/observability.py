"""Metrics registry and a small in-process tracer.

Counterpart of ``synapseml_tpu/core/observability.py``:

* :class:`MetricsRegistry` (``:65-455`` there): process-wide Counter, Gauge
  and Histogram families with labeled series, fixed histogram buckets and
  pull-time collectors, read through ``snapshot()`` (bucket-interpolated
  p50/p95/p99 for histograms). The data loader, the trainer's non-finite
  guard and its throughput meter write to it.
* :class:`Tracer`: ``get_tracer().span(name, attributes)`` nests per thread
  and keeps the finished spans in a bounded buffer.

Prometheus exposition, trace-context headers and Chrome export come with
the port of the serving planes.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Any, Callable, Iterator

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
           "HandleCache", "get_registry", "reset_registry",
           "Span", "Tracer", "get_tracer"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

# Default latency buckets in milliseconds, the unit every *_ms series uses.
DEFAULT_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10_000, 30_000, 60_000)


class Sample:
    """One value a collector yields at snapshot time: a named value with
    labels; ``kind`` is the family type."""

    __slots__ = ("name", "labels", "value", "kind", "help")

    def __init__(self, name: str, labels: dict | None, value: float,
                 kind: str = "gauge", help: str = ""):
        self.name = name
        self.labels = dict(labels or {})
        self.value = float(value)
        self.kind = kind
        self.help = help


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _format_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _normalize_buckets(buckets) -> tuple:
    bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS_MS)))
    if not bounds:
        raise ValueError("histogram needs at least one bucket")
    return bounds


class _Metric:
    """One metric family: a name plus labeled child series, created on the
    first ``labels(...)`` call; a family without label names is itself one
    series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def labels(self, **labels) -> Any:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}, "
                             f"got {tuple(labels)}")
        key = _label_key(labels)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._series[key] = self._new_child()
            return child

    def _child_items(self) -> list[tuple[dict, Any]]:
        with self._lock:
            return [(dict(k), c) for k, c in self._series.items()]


class _CounterSeries:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    kind = "counter"

    def _new_child(self) -> _CounterSeries:
        return _CounterSeries()

    def inc(self, n: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(n)


class _GaugeSeries:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> _GaugeSeries:
        return _GaugeSeries()

    def set(self, v: float, **labels) -> None:
        self.labels(**labels).set(v)


class _HistogramSeries:
    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: tuple):
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out = {"count": total, "sum": round(s, 3),
               "buckets": {str(b): c for b, c in zip(self._buckets, counts)}}
        out["buckets"]["+Inf"] = counts[-1]
        for q in (0.5, 0.95, 0.99):
            out[f"p{int(q * 100)}"] = self._quantile(q, counts, total)
        return out

    def _quantile(self, q: float, counts: list, total: int) -> float | None:
        """Bucket-interpolated quantile (Prometheus ``histogram_quantile``
        semantics; None when empty)."""
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            lo = self._buckets[i - 1] if i > 0 else 0.0
            hi = self._buckets[i] if i < len(self._buckets) else None
            if cum + c >= rank:
                if c == 0 or hi is None:
                    return round(lo, 3)  # +Inf bucket: clamp to the last bound
                return round(lo + (hi - lo) * (rank - cum) / c, 3)
            cum += c
        return round(float(self._buckets[-1]), 3)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", label_names: tuple = (),
                 buckets: tuple | None = None):
        super().__init__(name, help, label_names)
        self.buckets = _normalize_buckets(buckets)

    def _new_child(self) -> _HistogramSeries:
        return _HistogramSeries(self.buckets)

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).observe(v)


class MetricsRegistry:
    """Registry of metric families and pull-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create by name; a second
    request with another kind, other label names or other buckets raises,
    so two callers cannot silently share one name. Collectors are callables
    that yield :class:`Sample` rows when ``snapshot()`` runs. Thread-safe."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], Iterator[Sample]]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, label_names: tuple,
                       **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.label_names}, requested "
                        f"{cls.__name__}{tuple(label_names)}")
                if kw.get("buckets") is not None and \
                        m.buckets != _normalize_buckets(kw["buckets"]):
                    raise ValueError(
                        f"metric {name!r} already registered with buckets "
                        f"{m.buckets}, requested {_normalize_buckets(kw['buckets'])}")
                return m
            m = self._metrics[name] = cls(name, help, tuple(label_names), **kw)
            return m

    def counter(self, name: str, help: str = "", label_names: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "", label_names: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "", label_names: tuple = (),
                  buckets: tuple | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def register_collector(self, fn: Callable[[], Iterator[Sample]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def snapshot(self) -> dict:
        """Flat view: counters and gauges as numbers, histograms as
        {count, sum, p50, p95, p99, buckets}; keys ``name{k="v",...}``."""
        out: dict[str, Any] = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
            collectors = list(self._collectors)
        for name, m in metrics:
            for labels, series in m._child_items():
                out[name + _format_labels(labels)] = (
                    series.snapshot() if m.kind == "histogram" else series.value)
        for fn in collectors:
            for s in fn():
                out[s.name + _format_labels(s.labels)] = s.value
        return out


class HandleCache:
    """Memo of metric handles for hot paths: ``build(registry)`` returns the
    handles a call site wants, and ``get()`` rebuilds them only when the
    global registry was replaced (``reset_registry``)."""

    def __init__(self, build: Callable[[MetricsRegistry], Any]):
        self._build = build
        self._reg: MetricsRegistry | None = None
        self._handles: Any = None
        self._lock = threading.Lock()

    def get(self) -> Any:
        reg = get_registry()
        if reg is not self._reg:
            with self._lock:
                if reg is not self._reg:
                    self._handles = self._build(reg)
                    self._reg = reg
        return self._handles


_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Replace the process-wide registry with an empty one (tests)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
        return _REGISTRY


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One timed operation; ``end()`` freezes its duration."""

    __slots__ = ("name", "parent", "attributes", "start_wall", "_start_mono",
                 "duration_ms", "status")

    def __init__(self, name: str, parent: "Span | None",
                 attributes: dict | None = None):
        self.name = name
        self.parent = parent
        self.attributes = dict(attributes or {})
        self.start_wall = time.time()
        self._start_mono = time.perf_counter()
        self.duration_ms: float | None = None
        self.status = "ok"

    def end(self, error: BaseException | None = None) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter() - self._start_mono) * 1e3
        if error is not None:
            self.status = "error"
            self.attributes.setdefault("error", f"{type(error).__name__}: {error}")

    def to_dict(self) -> dict:
        return {"name": self.name,
                "parent": self.parent.name if self.parent is not None else None,
                "start_wall": self.start_wall,
                "duration_ms": round(self.duration_ms or 0.0, 3),
                "status": self.status, "attributes": self.attributes}


class Tracer:
    """Nested spans with a per-thread context stack; finished spans go to a
    ring buffer of ``max_spans``, so a long-lived process never grows."""

    def __init__(self, max_spans: int = 10_000):
        self._local = threading.local()
        self._finished: list[Span] = []
        self._max_spans = int(max_spans)
        self._lock = threading.Lock()

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, attributes: dict | None = None) -> Iterator[Span]:
        stack = self._stack()
        s = Span(name, stack[-1] if stack else None, attributes)
        stack.append(s)
        error = None
        try:
            yield s
        except BaseException as e:
            error = e
            raise
        finally:
            s.end(error)
            del stack[stack.index(s):]
            with self._lock:
                self._finished.append(s)
                if len(self._finished) > self._max_spans:
                    del self._finished[:len(self._finished) - self._max_spans]

    def finished_spans(self) -> list[Span]:
        with self._lock:
            return list(self._finished)

    def spans_as_dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.finished_spans()]

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER
