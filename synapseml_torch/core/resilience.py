"""Retry policy for shard reads.

Counterpart of the retry half of ``synapseml_tpu/core/resilience.py``:
``RetryPolicy`` (``:127-176``), a backoff schedule with full jitter and an
optional ``RetryBudget`` (``:90``, a token bucket that bounds the rate of
retries), and ``resilience_measures`` (``:57``), one shared
``InstrumentationMeasures`` per plane whose ``retry`` count the data
sources bump (the breaker, deadline and fault counts come with those
planes). Circuit breakers and deadlines come with the serving planes.
"""

from __future__ import annotations

import dataclasses
import random
import threading

from .instrumentation import InstrumentationMeasures

__all__ = ["RetryPolicy", "RetryBudget", "resilience_measures",
           "reset_resilience_measures"]

_COUNTERS = ("retry",)
_PLANES: dict[str, InstrumentationMeasures] = {}
_PLANES_LOCK = threading.Lock()


def resilience_measures(plane: str) -> InstrumentationMeasures:
    """The shared ``InstrumentationMeasures`` of a named plane (``"data"``
    here); its counter starts at 0 so ``to_dict()`` always has it."""
    with _PLANES_LOCK:
        m = _PLANES.get(plane)
        if m is None:
            m = _PLANES[plane] = InstrumentationMeasures()
            for name in _COUNTERS:
                m.count(name, 0)
        return m


def reset_resilience_measures(plane: str | None = None) -> None:
    """Drop accumulated measures (tests)."""
    with _PLANES_LOCK:
        if plane is None:
            _PLANES.clear()
        else:
            _PLANES.pop(plane, None)


class RetryBudget:
    """Token bucket bounding the rate of retries: each retry spends a token,
    each first-attempt success deposits ``deposit_per_success`` back, up to
    ``max_tokens``. An empty bucket makes callers fail fast. Thread-safe."""

    def __init__(self, max_tokens: float = 10.0,
                 deposit_per_success: float = 0.1,
                 initial_tokens: float | None = None):
        self.max_tokens = float(max_tokens)
        self.deposit_per_success = float(deposit_per_success)
        self._tokens = self.max_tokens if initial_tokens is None else float(initial_tokens)
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
            self._tokens = min(self.max_tokens, self._tokens + self.deposit_per_success)


@dataclasses.dataclass
class RetryPolicy:
    """Backoff schedule with full jitter and an optional retry budget.

    Attempt i sleeps about ``backoffs_ms[i]`` (uniform in (0, backoff] with
    ``jitter``); there are ``len(backoffs_ms) + 1`` attempts in all. Pass a
    seeded ``random.Random`` as ``rng`` for a reproducible schedule."""

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
        return (self.rng if self.rng is not None else _SHARED_RNG).uniform(0.0, base)

    def acquire_retry(self) -> bool:
        """True when another retry is allowed (spends budget if present)."""
        return self.budget is None or self.budget.try_spend()

    def on_success(self, first_attempt: bool = True) -> None:
        """Only a first-attempt success deposits into the budget."""
        if self.budget is not None and first_attempt:
            self.budget.deposit()


_SHARED_RNG = random.Random()
