"""Metrics registry, trace spans and their exporters.

Counterpart of ``synapseml_tpu/core/observability.py``, copied whole:

* :class:`MetricsRegistry`: process-wide Counter, Gauge and Histogram
  families with labeled series, fixed histogram buckets and pull-time
  collectors; Prometheus text exposition (:func:`prometheus_exposition`,
  byte for byte the JAX package's for the same samples, which the serving
  planes serve as ``GET /metrics``) and ``snapshot()`` with
  bucket-interpolated p50/p95/p99.
* Adapters: :func:`register_resilience_collector` (every
  ``resilience_measures`` plane's counters), :func:`register_instrumentation`
  (any ``InstrumentationMeasures``) and :func:`observe_stage` (each
  ``StageTelemetry`` fit/transform).
* :class:`Tracer`: nested spans per thread with W3C ``traceparent``
  propagation (:func:`format_traceparent`, :func:`parse_traceparent`,
  :func:`extract_context`), so a request's spans join its caller's trace;
  :func:`chrome_trace_events` / :func:`export_chrome_trace` write the
  Chrome/Perfetto trace-event JSON. A span's dict also names its parent
  span (``parent``) when the parent ran in this process.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import threading
import time
import uuid
import weakref
from typing import Any, Callable, Iterator

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
    "HandleCache",
    "get_registry", "reset_registry", "prometheus_exposition",
    "register_resilience_collector", "register_instrumentation",
    "observe_stage",
    "Span", "SpanContext", "Tracer", "get_tracer", "reset_tracer",
    "format_traceparent", "parse_traceparent",
    "chrome_trace_events", "export_chrome_trace",
]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

# Default latency buckets in MILLISECONDS (the repo's native unit — phase
# windows, stage durations and serving latencies all export ``*_ms``).
# Spans sub-ms loopback serving up to multi-minute training phases.
DEFAULT_BUCKETS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                      1000, 2500, 5000, 10_000, 30_000, 60_000)


class Sample:
    """One exposition-ready sample a collector can yield: a named value with
    labels. ``kind`` is the Prometheus family type."""

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


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _format_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _normalize_buckets(buckets) -> tuple:
    bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS_MS)))
    if not bounds:
        raise ValueError("histogram needs at least one bucket")
    return bounds


class _Metric:
    """One metric family: a name plus labeled child series. Children are
    created on first ``labels(...)`` call; the bare family (no labels) is
    itself a series so unlabeled ``inc``/``set``/``observe`` work directly."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def labels(self, **labels) -> "Any":
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = _label_key(labels)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._new_child()
                self._series[key] = child
            return child

    def _child_items(self) -> list[tuple[dict, Any]]:
        with self._lock:
            return [(dict(k), c) for k, c in self._series.items()]

    def _default_child(self):
        return self.labels()


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

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

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

    def inc(self, n: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(n)


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
        """Bucket-interpolated quantile estimate (Prometheus
        ``histogram_quantile`` semantics; None when empty)."""
        if total == 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            lo = self._buckets[i - 1] if i > 0 else 0.0
            hi = self._buckets[i] if i < len(self._buckets) else None
            if cum + c >= rank:
                if c == 0 or hi is None:
                    return round(lo, 3)  # +Inf bucket: clamp to last bound
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

    @contextlib.contextmanager
    def time_ms(self, **labels) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe((time.perf_counter() - t0) * 1e3, **labels)


class MetricsRegistry:
    """Process-wide registry of metric families + pull-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent per
    name; a kind mismatch raises — two subsystems cannot silently fight over
    one name). Collectors are callables invoked at exposition/snapshot time
    yielding :class:`Sample` rows — used for state owned elsewhere (breaker
    states, resilience-plane counters) so the registry never caches stale
    copies. Thread-safe throughout."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], Iterator[Sample]]] = []
        self._lock = threading.Lock()

    # -- registration -----------------------------------------------------
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
                    # silently sharing a family with different boundaries
                    # would dump one caller's observations into +Inf
                    raise ValueError(
                        f"metric {name!r} already registered with buckets "
                        f"{m.buckets}, requested "
                        f"{_normalize_buckets(kw['buckets'])}")
                return m
            m = cls(name, help, tuple(label_names), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_names: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "", label_names: tuple = (),
                  buckets: tuple | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def register_collector(self, fn: Callable[[], Iterator[Sample]]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- exposition -------------------------------------------------------
    def _collected(self) -> list[Sample]:
        with self._lock:
            collectors = list(self._collectors)
        out: list[Sample] = []
        for fn in collectors:
            try:
                out.extend(fn())
            except Exception:  # noqa: BLE001 — one bad collector must not
                continue       # take down the whole /metrics endpoint
        return out

    def exposition(self) -> str:
        """Prometheus text format 0.0.4 (``# HELP``/``# TYPE`` + samples;
        histograms expand to ``_bucket``/``_sum``/``_count``)."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            lines.append(f"# HELP {name} {m.help or name}")
            lines.append(f"# TYPE {name} {m.kind}")
            for labels, series in m._child_items():
                label_str = _format_labels(labels)
                if m.kind == "histogram":
                    snap = series.snapshot()
                    cum = 0
                    for b in m.buckets:
                        cum += snap["buckets"][str(b)]
                        le = _format_labels(labels, {"le": _fmt_float(b)})
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _format_labels(labels, {"le": "+Inf"})
                    lines.append(f"{name}_bucket{le} {snap['count']}")
                    lines.append(f"{name}_sum{label_str} {_fmt_float(snap['sum'])}")
                    lines.append(f"{name}_count{label_str} {snap['count']}")
                else:
                    lines.append(f"{name}{label_str} {_fmt_float(series.value)}")
        by_name: dict[str, list[Sample]] = {}
        for s in self._collected():
            by_name.setdefault(s.name, []).append(s)
        for name in sorted(by_name):
            samples = by_name[name]
            lines.append(f"# HELP {name} {samples[0].help or name}")
            lines.append(f"# TYPE {name} {samples[0].kind}")
            for s in samples:
                lines.append(
                    f"{name}{_format_labels(s.labels)} {_fmt_float(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat JSON-able view for bench records: counters/gauges as numbers,
        histograms as {count, sum, p50, p95, p99, buckets}. Series keys are
        ``name{k=v,...}``."""
        out: dict[str, Any] = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            for labels, series in m._child_items():
                key = name + _format_labels(labels)
                out[key] = (series.snapshot() if m.kind == "histogram"
                            else series.value)
        for s in self._collected():
            out[s.name + _format_labels(s.labels)] = s.value
        return out


def _fmt_float(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class HandleCache:
    """Per-registry memo of metric handles for hot paths.

    ``build(registry)`` returns whatever handle structure the call site wants
    (a dict of ``.labels()`` children, say); ``get()`` rebuilds only when the
    global registry was replaced (``reset_registry`` in tests) — so a request
    path pays one identity check instead of get-or-create lock traffic per
    event."""

    def __init__(self, build: Callable[["MetricsRegistry"], Any]):
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
    """The process-wide default registry (what ``GET /metrics`` serves)."""
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Replace the global registry with a fresh one (tests). Pre-wired
    collectors (resilience planes) are re-registered on the new registry."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
        register_resilience_collector(_REGISTRY)
        return _REGISTRY


def prometheus_exposition() -> tuple[bytes, str]:
    """(payload, content-type) for an HTTP /metrics handler."""
    return (get_registry().exposition().encode("utf-8"),
            "text/plain; version=0.0.4; charset=utf-8")


# ---------------------------------------------------------------------------
# adapters: the pre-existing fragments become first-class series
# ---------------------------------------------------------------------------

def _resilience_samples() -> Iterator[Sample]:
    from .resilience import all_resilience_measures

    for plane, d in sorted(all_resilience_measures().items()):
        for k, v in sorted(d.items()):
            if k.endswith("_count"):
                yield Sample(f"synapseml_resilience_{k[:-6]}_total",
                             {"plane": plane}, v, kind="counter",
                             help="resilience plane counter "
                                  "(core/resilience.py)")


def register_resilience_collector(registry: MetricsRegistry | None = None) -> None:
    """Export every ``resilience_measures(plane)`` counter as
    ``synapseml_resilience_<name>_total{plane=...}`` — pull-time, so the
    planes stay the single source of truth."""
    (registry or get_registry()).register_collector(_resilience_samples)


def register_instrumentation(prefix: str, measures,
                             labels: dict | None = None,
                             registry: MetricsRegistry | None = None) -> None:
    """Expose an :class:`~synapseml_torch.core.instrumentation.
    InstrumentationMeasures` as pull-time series: phase windows become
    ``<prefix>_<phase>_ms`` gauges, counts become ``<prefix>_<name>_total``
    counters. Holds the collector via weakref — a dropped collector silently
    stops exporting instead of pinning train state alive."""
    ref = weakref.ref(measures)
    labels = dict(labels or {})

    def collect() -> Iterator[Sample]:
        m = ref()
        if m is None:
            return
        for k, v in m.to_dict().items():
            if k.endswith("_count"):
                yield Sample(f"{prefix}_{k[:-6]}_total", labels, v,
                             kind="counter", help=f"{prefix} counter")
            elif k.endswith("_ms"):
                yield Sample(f"{prefix}_{k}", labels, v, kind="gauge",
                             help=f"{prefix} phase window (ms)")

    (registry or get_registry()).register_collector(collect)


def observe_stage(class_name: str, method: str, duration_ms: float,
                  error: bool = False) -> None:
    """Record one StageTelemetry fit/transform event (called by
    ``core/logging.py`` on every ``log_verb``): duration histogram + event
    counter, labeled by stage class and verb."""
    reg = get_registry()
    reg.histogram(
        "synapseml_stage_duration_ms",
        "StageTelemetry fit/transform duration (SynapseMLLogging analog)",
        ("stage", "method"),
    ).observe(duration_ms, stage=class_name, method=method)
    reg.counter(
        "synapseml_stage_events_total", "StageTelemetry events by outcome",
        ("stage", "method", "status"),
    ).inc(stage=class_name, method=method,
          status="error" if error else "ok")


register_resilience_collector(_REGISTRY)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

_TRACEPARENT_HEADER = "traceparent"


class SpanContext:
    """What crosses a process/thread boundary: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


def format_traceparent(ctx: SpanContext) -> str:
    """W3C Trace Context: ``00-<32hex trace>-<16hex span>-01``."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(value: str | None) -> SpanContext | None:
    """Parse a ``traceparent`` header; None on absence or malformed input
    (a bad upstream header must start a fresh trace, never raise)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    if parts[1] == "0" * 32 or parts[2] == "0" * 16:
        return None
    return SpanContext(parts[1].lower(), parts[2].lower())


def extract_context(headers) -> SpanContext | None:
    """Pull a SpanContext out of an HTTP header mapping (case-insensitive)."""
    if headers is None:
        return None
    for k in (_TRACEPARENT_HEADER, "Traceparent", "TRACEPARENT"):
        v = headers.get(k) if hasattr(headers, "get") else None
        if v:
            return parse_traceparent(v)
    # BaseHTTPRequestHandler headers are email.message.Message — already
    # case-insensitive via get; plain dicts with odd casing land here
    try:
        for k, v in headers.items():
            if k.lower() == _TRACEPARENT_HEADER:
                return parse_traceparent(v)
    except AttributeError:
        pass
    return None


class Span:
    """One timed operation. ``end()`` freezes duration; finished spans land
    in the tracer's ring buffer for export."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "parent",
                 "attributes", "start_wall", "_start_mono", "duration_ms",
                 "status", "pid", "tid")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, attributes: dict | None = None,
                 parent: "Span | None" = None):
        self.name = name
        self.parent = parent  # the enclosing span of this process, if any
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attributes = dict(attributes or {})
        self.start_wall = time.time()
        self._start_mono = time.perf_counter()
        self.duration_ms: float | None = None
        self.status = "ok"
        self.pid = os.getpid()
        self.tid = threading.get_ident()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def end(self, error: BaseException | None = None) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter() - self._start_mono) * 1e3
        if error is not None:
            self.status = "error"
            self.attributes.setdefault(
                "error", f"{type(error).__name__}: {error}")

    def to_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "parent": self.parent.name if self.parent is not None else None,
            "start_wall": self.start_wall,
            "duration_ms": round(self.duration_ms or 0.0, 3),
            "status": self.status, "pid": self.pid, "tid": self.tid,
            "attributes": self.attributes,
        }


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Nested spans with a PER-THREAD context stack. ``span(...)`` nests
    under the thread's current span unless ``parent`` (a
    :class:`SpanContext`, e.g. extracted from ``traceparent``) pins it to a
    remote trace. Finished spans go to a bounded ring buffer
    (``max_spans``) — long-lived servers never grow without bound."""

    def __init__(self, max_spans: int = 10_000):
        self._local = threading.local()
        self._finished: list[Span] = []
        self._max_spans = int(max_spans)
        self._lock = threading.Lock()

    # -- context stack ----------------------------------------------------
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Span | None:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_context(self) -> SpanContext | None:
        span = self.current_span()
        return span.context if span is not None else None

    # -- span lifecycle ---------------------------------------------------
    def start_span(self, name: str, attributes: dict | None = None,
                   parent: SpanContext | None = None) -> Span:
        cur = self.current_span()
        if parent is None:
            parent = cur.context if cur is not None else None
        else:
            cur = None  # pinned to a remote trace: no local parent
        if parent is None:
            span = Span(name, _new_trace_id(), _new_span_id(), None,
                        attributes)
        else:
            span = Span(name, parent.trace_id, _new_span_id(),
                        parent.span_id, attributes, parent=cur)
        self._stack().append(span)
        return span

    def end_span(self, span: Span, error: BaseException | None = None) -> None:
        span.end(error)
        stack = self._stack()
        if span in stack:
            # pop through (tolerates a leaked deeper span)
            del stack[stack.index(span):]
        with self._lock:
            self._finished.append(span)
            if len(self._finished) > self._max_spans:
                del self._finished[:len(self._finished) - self._max_spans]

    @contextlib.contextmanager
    def span(self, name: str, attributes: dict | None = None,
             parent: SpanContext | None = None) -> Iterator[Span]:
        s = self.start_span(name, attributes, parent)
        try:
            yield s
        except BaseException as e:
            self.end_span(s, error=e)
            raise
        else:
            self.end_span(s)

    # -- headers ----------------------------------------------------------
    def inject(self, headers: dict) -> dict:
        """Stamp the current context's ``traceparent`` into ``headers``
        (mutates and returns it; no-op without an active span)."""
        ctx = self.current_context()
        if ctx is not None:
            headers[_TRACEPARENT_HEADER] = format_traceparent(ctx)
        return headers

    # -- export -----------------------------------------------------------
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
    """The process-wide tracer (what ``GET /trace`` serves)."""
    return _TRACER


def reset_tracer(max_spans: int = 10_000) -> Tracer:
    global _TRACER
    _TRACER = Tracer(max_spans)
    return _TRACER


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace-event export
# ---------------------------------------------------------------------------

def chrome_trace_events(span_dicts: list[dict] | None = None) -> dict:
    """Spans -> Chrome trace-event JSON (the ``chrome://tracing`` /
    Perfetto format): one complete ("X") event per span, microsecond
    timestamps, pid/tid preserved so a STITCHED multi-process trace (front +
    workers' ``/trace`` outputs concatenated) renders as one timeline.
    Accepts plain span dicts so cross-process JSON needs no deserialization
    into Span objects."""
    if span_dicts is None:
        span_dicts = get_tracer().spans_as_dicts()
    events = []
    procs = {}
    for d in span_dicts:
        pid = d.get("pid", 0)
        if pid not in procs:
            procs[pid] = True
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0,
                           "args": {"name": f"synapseml pid {pid}"}})
        args = dict(d.get("attributes") or {})
        args.update({"trace_id": d.get("trace_id"),
                     "span_id": d.get("span_id"),
                     "parent_id": d.get("parent_id"),
                     "status": d.get("status", "ok")})
        events.append({
            "ph": "X", "name": d.get("name", "?"), "cat": "synapseml",
            "ts": round(float(d.get("start_wall", 0.0)) * 1e6, 3),
            "dur": round(float(d.get("duration_ms", 0.0)) * 1e3, 3),
            "pid": pid, "tid": d.get("tid", 0), "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        span_dicts: list[dict] | None = None) -> str:
    """Write the Chrome trace-event JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace_events(span_dicts), f)
    return path
