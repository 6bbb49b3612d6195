"""Shared resilience kernel: retry policies, circuit breakers, deadlines.

Counterpart of ``synapseml_tpu/core/resilience.py``, copied whole:

* ``RetryPolicy`` (a backoff schedule with full jitter) and its optional
  ``RetryBudget`` (a token bucket that bounds the rate of retries), used by
  the data sources and the rendezvous;
* ``CircuitBreaker``: closed / open / half-open over a failure-rate window
  with a probe interval;
* ``Deadline``: a total time budget that caps every attempt's timeout, so
  retries never multiply the worst-case latency.

Every plane counts on its own ``InstrumentationMeasures``
(``resilience_measures(plane)``): ``retry_count``, ``breaker_open_count``,
``deadline_expired_count``, ``faults_injected_count``;
``all_resilience_measures`` reads them all (the metrics registry exports
them as ``synapseml_resilience_<name>_total{plane=...}``).
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from typing import Callable

from .instrumentation import InstrumentationMeasures

__all__ = ["RetryPolicy", "RetryBudget", "CircuitBreaker", "Deadline",
           "DeadlineExpired", "resilience_measures", "reset_resilience_measures",
           "all_resilience_measures"]


# ---------------------------------------------------------------------------
# per-plane instrumentation registry
# ---------------------------------------------------------------------------

_COUNTERS = ("retry", "breaker_open", "deadline_expired", "faults_injected")
_PLANES: dict[str, InstrumentationMeasures] = {}
_PLANES_LOCK = threading.Lock()


def resilience_measures(plane: str) -> InstrumentationMeasures:
    """The shared ``InstrumentationMeasures`` for a named plane (``"http"``,
    ``"distributed_serving"``, ``"services"``, ``"parallel"``). Counters are
    pre-seeded at 0 so ``to_dict()`` always exports the full set."""
    with _PLANES_LOCK:
        m = _PLANES.get(plane)
        if m is None:
            m = InstrumentationMeasures()
            for name in _COUNTERS:
                m.count(name, 0)
            _PLANES[plane] = m
        return m


def reset_resilience_measures(plane: str | None = None) -> None:
    """Drop accumulated measures (tests; per-run stats snapshots)."""
    with _PLANES_LOCK:
        if plane is None:
            _PLANES.clear()
        else:
            _PLANES.pop(plane, None)


def all_resilience_measures() -> dict[str, dict]:
    with _PLANES_LOCK:
        planes = dict(_PLANES)
    return {name: m.to_dict() for name, m in planes.items()}


# ---------------------------------------------------------------------------
# retry budget + policy
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token bucket bounding the RATE of retries, not just the count per call
    (the SRE "retry budget" pattern): each retry spends one token; each
    successful first attempt deposits ``deposit_per_success`` back, capped at
    ``max_tokens``. When the bucket is empty retries are skipped and the
    caller fails fast — a storm of failures cannot amplify itself into
    ``max_attempts x`` the offered load. Thread-safe, shared per client."""

    def __init__(self, max_tokens: float = 10.0,
                 deposit_per_success: float = 0.1,
                 initial_tokens: float | None = None):
        self.max_tokens = float(max_tokens)
        self.deposit_per_success = float(deposit_per_success)
        self._tokens = self.max_tokens if initial_tokens is None \
            else float(initial_tokens)
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def try_spend(self, n: float = 1.0) -> bool:
        """True (and spends) when the budget allows another retry."""
        with self._lock:
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.deposit_per_success)


@dataclasses.dataclass
class RetryPolicy:
    """Jittered exponential backoff schedule + optional retry budget.

    ``backoffs_ms`` keeps the existing tuple shape used across the codebase
    (attempt i sleeps ~backoffs_ms[i]; total attempts = len + 1). With
    ``jitter`` (default), each sleep is drawn uniform(0, backoff] — FULL
    jitter, so concurrent executors never synchronize their retries. Pass a
    seeded ``random.Random`` as ``rng`` for reproducible schedules."""

    backoffs_ms: tuple = (100, 500, 1000)
    jitter: bool = True
    budget: RetryBudget | None = None
    rng: random.Random | None = None
    max_backoff_ms: float = 30_000.0

    @property
    def max_attempts(self) -> int:
        return len(self.backoffs_ms) + 1

    def backoff_ms(self, attempt: int) -> float:
        if not self.backoffs_ms:
            return 0.0
        base = min(float(self.backoffs_ms[min(attempt, len(self.backoffs_ms) - 1)]),
                   self.max_backoff_ms)
        if not self.jitter:
            return base
        r = self.rng if self.rng is not None else _SHARED_RNG
        return r.uniform(0.0, base)

    def acquire_retry(self) -> bool:
        """True when another retry is allowed (spends budget if present)."""
        return self.budget is None or self.budget.try_spend()

    def on_success(self, first_attempt: bool = True) -> None:
        """Report a successful request. Only FIRST-attempt successes deposit
        into the budget — a success that itself consumed a retry token must
        not replenish it, or the bucket drains far slower than the retry-rate
        bound intends."""
        if self.budget is not None and first_attempt:
            self.budget.deposit()


# module-shared rng: deterministic tests pass their own seeded Random
_SHARED_RNG = random.Random()


# ---------------------------------------------------------------------------
# deadline
# ---------------------------------------------------------------------------

class DeadlineExpired(TimeoutError):
    """The total time budget for an operation (all attempts) ran out."""


class Deadline:
    """A propagated total time budget. ``cap(timeout_s)`` bounds each
    attempt's timeout by the remaining budget so N retries can never take
    N x timeout; ``sleep_allowed(s)`` gates backoff sleeps the same way.
    ``clock`` is injectable for tests."""

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._expires_at = clock() + self.budget_s

    def remaining(self) -> float:
        return self._expires_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def cap(self, timeout_s: float) -> float:
        """min(timeout_s, remaining); raises ``DeadlineExpired`` at 0."""
        rem = self.remaining()
        if rem <= 0.0:
            raise DeadlineExpired(
                f"deadline of {self.budget_s:.3f}s expired")
        return min(float(timeout_s), rem)

    def sleep_allowed(self, wait_s: float) -> bool:
        return wait_s < self.remaining()

    def __repr__(self):
        return f"Deadline(budget_s={self.budget_s}, remaining={self.remaining():.3f})"


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Closed / open / half-open breaker with a failure-RATE window.

    * closed: outcomes feed a ring of the last ``window`` results; when at
      least ``min_samples`` are present, at least one failed, and the failure
      fraction >= ``failure_rate_threshold``, the breaker OPENS (counted as
      ``breaker_open`` on ``measures``).
    * open: calls are refused until ``probe_interval_s`` has elapsed since
      the (most recent) failure that opened it, then the breaker moves to
      half-open — the distributed-serving "resurrection" timer.
    * half-open: up to ``half_open_probes`` leased probes; any success closes
      the breaker (clearing the window), a failure re-opens it. Probe leases
      that are never resolved (caller routed elsewhere) expire after another
      ``probe_interval_s`` so a leaked lease cannot wedge the breaker.

    ``failure_rate_threshold=0.0`` (with window=1) reproduces the old
    any-failure-marks-dead front semantics. ``clock`` is injectable so tests
    drive transitions without sleeping. Thread-safe."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_rate_threshold: float = 0.5, window: int = 10,
                 min_samples: int = 1, probe_interval_s: float = 2.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 measures: InstrumentationMeasures | None = None,
                 name: str = ""):
        self.failure_rate_threshold = float(failure_rate_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.half_open_probes = int(half_open_probes)
        self.min_samples = max(int(min_samples), 1)
        self.name = name
        self._outcomes: collections.deque = collections.deque(maxlen=max(int(window), 1))
        self._clock = clock
        self._measures = measures
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.opened_at: float | None = None
        self.last_failure_at: float | None = None
        self._half_open_at: float | None = None
        self._probes_leased = 0

    # -- transitions (lock held) ------------------------------------------
    def _to_open(self, now: float) -> None:
        self.state = self.OPEN
        self.opened_at = now
        self._probes_leased = 0
        if self._measures is not None:
            self._measures.count("breaker_open")

    def _to_half_open(self, now: float) -> None:
        self.state = self.HALF_OPEN
        self._half_open_at = now
        self._probes_leased = 0

    def _to_closed(self) -> None:
        self.state = self.CLOSED
        self._outcomes.clear()
        self._probes_leased = 0
        self.opened_at = None

    # -- queries / outcomes -----------------------------------------------
    def available(self) -> bool:
        """Read-only: would ``allow()`` grant a call right now? (Does not
        transition state or lease probes — safe for building candidate
        lists.)"""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            now = self._clock()
            if self.state == self.OPEN:
                return now - (self.opened_at or 0.0) >= self.probe_interval_s
            return self._probes_leased < self.half_open_probes or \
                now - (self._half_open_at or 0.0) >= self.probe_interval_s

    def allow(self) -> bool:
        """Lease one call: True in closed; in open, True only once the probe
        interval elapsed (transitioning to half-open); in half-open, True for
        up to ``half_open_probes`` outstanding probes."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            now = self._clock()
            if self.state == self.OPEN:
                if now - (self.opened_at or 0.0) < self.probe_interval_s:
                    return False
                self._to_half_open(now)
            elif now - (self._half_open_at or 0.0) >= self.probe_interval_s:
                # stale probe leases (caller never reported back): re-arm
                self._half_open_at = now
                self._probes_leased = 0
            if self._probes_leased < self.half_open_probes:
                self._probes_leased += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state != self.CLOSED:
                self._to_closed()   # probe (or desperation call) succeeded
                return
            self._outcomes.append(True)

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            self.last_failure_at = now
            if self.state == self.HALF_OPEN:
                self._to_open(now)   # probe failed: back to open
                return
            if self.state == self.OPEN:
                self.opened_at = now  # desperation probe failed: re-stamp
                return
            self._outcomes.append(False)
            n = len(self._outcomes)
            failures = n - sum(self._outcomes)
            if (n >= self.min_samples and failures >= 1
                    and failures / n >= self.failure_rate_threshold):
                self._to_open(now)

    def __repr__(self):
        return (f"CircuitBreaker({self.name or 'unnamed'}: {self.state}, "
                f"window={list(self._outcomes)})")
