"""A small in-process tracer.

Counterpart of the span half of ``synapseml_tpu/core/observability.py``:
``get_tracer().span(name, attributes)`` nests per thread and keeps the
finished spans in a bounded buffer. The metrics registry, trace-context
headers and Chrome export of the JAX package come with the port of the
serving planes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

__all__ = ["Span", "Tracer", "get_tracer"]


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
