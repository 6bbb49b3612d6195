"""Deterministic, seeded fault injection.

Counterpart of ``synapseml_tpu/core/faults.py``, copied whole (pure
Python): a process-wide :class:`FaultPlan` installed by the
:func:`inject_faults` context manager, consulted by each hook point before
it touches storage or the network. In this package the streaming data
plane calls it: every guarded shard read of ``data/source.py`` calls
``plan.on_read(target)`` (slow or failing reads on the ``"data"`` plane;
the source retries them under its ``RetryPolicy``). Target the plane
explicitly: ``FaultSpec(..., planes=("data",))``. The other hooks
(``on_http_send``, ``on_connect``, ``on_training``, ``on_continual``,
``on_gang``) keep the JAX package's semantics for the planes that call
them there.

Faults are matched in order against the target (a substring), gated by a
per-spec remaining ``times`` count and a probability drawn from ONE seeded
``random.Random``: the same seed and the same call sequence always yield
the same injected sequence. Every injection is appended to
``plan.injected`` and counted as ``faults_injected`` on the plane's
``resilience_measures``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import email.message
import io
import random
import threading
import time
import urllib.error

from .resilience import resilience_measures

__all__ = ["FaultSpec", "FaultPlan", "inject_faults", "active_fault_plan"]

FAULT_KINDS = ("connection_error", "status", "latency", "blackhole", "crash",
               "drop")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule. ``kind``:

    * ``connection_error`` — raise ``ConnectionRefusedError`` (OSError);
    * ``status`` — raise ``urllib.error.HTTPError(status)`` with an optional
      ``Retry-After`` header (seconds or an HTTP-date string; http plane only);
    * ``latency`` — sleep ``latency_ms`` then proceed normally;
    * ``blackhole`` — sleep ``latency_ms`` then raise ``TimeoutError`` (the
      worker accepts nothing, the client's timeout fires);
    * ``crash`` — raise ``ConnectionResetError`` (the worker died mid-flight);
    * ``drop`` — silently suppress the guarded action (``gang`` plane:
      the heartbeat is not sent, modeling a lost datagram/partition —
      after ``latency_ms``, if set).
    """

    kind: str
    probability: float = 1.0
    times: int | None = None          # max injections; None = unlimited
    match: str | None = None          # substring of the target; None = all
    status: int = 503
    retry_after: str | float | None = None
    latency_ms: float = 0.0
    planes: tuple = ("http", "distributed_serving")

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")


class FaultPlan:
    """An ordered list of ``FaultSpec`` rules + one seeded RNG. Thread-safe;
    ``injected`` is the deterministic log of (plane, kind, target) tuples."""

    def __init__(self, faults, seed: int = 0):
        self.faults: list[FaultSpec] = list(faults)
        self.seed = seed
        self._rng = random.Random(seed)
        self._fired = [0] * len(self.faults)
        self._lock = threading.RLock()
        self.injected: list[tuple[str, str, str]] = []

    def fired(self, index: int) -> int:
        with self._lock:
            return self._fired[index]

    def _select(self, plane: str, target: str) -> FaultSpec | None:
        with self._lock:
            for i, f in enumerate(self.faults):
                if plane not in f.planes:
                    continue
                if f.kind == "status" and plane != "http":
                    continue   # an HTTP status needs the urllib send path
                if f.times is not None and self._fired[i] >= f.times:
                    continue
                if f.match is not None and f.match not in target:
                    continue
                if f.probability < 1.0 and self._rng.random() >= f.probability:
                    continue
                self._fired[i] += 1
                self.injected.append((plane, f.kind, target))
                resilience_measures(plane).count("faults_injected")
                return f
        return None

    @staticmethod
    def _raise_fault(f: FaultSpec, target: str) -> None:
        if f.latency_ms > 0:
            time.sleep(f.latency_ms / 1000.0)
        if f.kind in ("latency", "drop"):
            # 'drop' only SUPPRESSES on hooks that can express it (the
            # gang plane returns True before reaching here); on a
            # raise-only hook it degrades to a recorded no-op rather than
            # falling through to a nonsense HTTP status
            return
        if f.kind == "connection_error":
            raise ConnectionRefusedError(f"injected connection error: {target}")
        if f.kind == "blackhole":
            raise TimeoutError(f"injected blackhole (timed out): {target}")
        if f.kind == "crash":
            raise ConnectionResetError(f"injected worker crash: {target}")
        # status
        headers = email.message.Message()
        if f.retry_after is not None:
            headers["Retry-After"] = str(f.retry_after)
        raise urllib.error.HTTPError(target, f.status,
                                     f"injected HTTP {f.status}", headers,
                                     io.BytesIO(b""))

    # -- hook points --------------------------------------------------------
    def on_http_send(self, url: str) -> None:
        """Called by the io/http send path before each real request."""
        f = self._select("http", url)
        if f is not None:
            self._raise_fault(f, url)

    def on_connect(self, key: tuple) -> None:
        """Called by the distributed-serving connection pool before handing
        out a (pooled or fresh) worker connection."""
        target = f"{key[0]}:{key[1]}"
        f = self._select("distributed_serving", target)
        if f is not None:
            self._raise_fault(f, target)

    def on_read(self, target: str) -> None:
        """Called by the streaming data plane before each physical shard
        read (``data/source.py``). ``connection_error``/``blackhole``/
        ``crash``/``latency`` model slow or failing storage; reads are
        retried by the source's ``RetryPolicy``."""
        f = self._select("data", target)
        if f is not None:
            self._raise_fault(f, target)

    def on_training(self, target: str) -> None:
        """Called by the training supervisor (``continual/supervisor.py``)
        at attempt starts and step heartbeats — ``crash`` models a dying
        trainer process; the supervisor restarts it under its
        ``RetryPolicy`` from the latest verified checkpoint."""
        f = self._select("training", target)
        if f is not None:
            self._raise_fault(f, target)

    def on_continual(self, target: str) -> None:
        """Called by the continual-training flywheel at every seam
        (``continual/loop.py`` / ``logger.py``) — an injected fault must
        abort ONE loop iteration without touching ``prod``."""
        f = self._select("continual", target)
        if f is not None:
            self._raise_fault(f, target)

    def on_gang(self, target: str) -> bool:
        """Called by the elastic gang channel (``parallel/gang.py``) before
        each worker heartbeat send — ``target`` is
        ``beat:rank=<r>:step=<n>``, so a seeded plan can drop or delay a
        specific host's beats (``drop``/``latency``) or kill the worker at
        an exact step (``crash`` → the heartbeat raises, the training
        process dies, the gang's failure detector takes over). Returns
        True when the beat must be SUPPRESSED (``drop``)."""
        f = self._select("gang", target)
        if f is None:
            return False
        if f.kind == "drop":
            if f.latency_ms > 0:
                time.sleep(f.latency_ms / 1000.0)
            return True
        self._raise_fault(f, target)
        return False


_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


def active_fault_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def inject_faults(plan_or_faults, seed: int = 0):
    """Install a fault plan process-wide for the duration of the block::

        with inject_faults([FaultSpec("status", status=429, retry_after=0,
                                      times=2)]) as plan:
            resp = send_with_retries(req)
        assert len(plan.injected) == 2

    Accepts a ``FaultPlan`` or an iterable of ``FaultSpec``. Nesting is
    refused — one deterministic sequence at a time."""
    plan = plan_or_faults if isinstance(plan_or_faults, FaultPlan) \
        else FaultPlan(plan_or_faults, seed=seed)
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault plan is already active")
        _ACTIVE = plan
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
