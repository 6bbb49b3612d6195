"""Admission control for the routing front: token buckets, priority
classes, p99-budget load shedding.

Counterpart of ``synapseml_tpu/fleet/admission.py``, copied whole.

The resilience plane's circuit breakers protect WORKERS — a dead
worker stops receiving traffic. This module protects SLOs: a model whose
offered load exceeds its declared budget sheds the excess AT THE FRONT with
``429 Too Many Requests`` + ``Retry-After``, before a request costs a
worker queue slot or a batch rung. Three rules, all per-model
(:class:`~synapseml_torch.fleet.spec.AdmissionPolicy`):

* **token bucket** — ``rate_rps``/``burst`` bound sustained admission rate;
* **priority classes** — ``interactive`` > ``bulk``: bulk requests (the
  ``X-Priority: bulk`` header ``transform_source``-style clients send) may
  not spend the bucket below ``interactive_reserve × burst``, so bulk
  traffic can never starve interactive admission;
* **p99 shedding** — when the model's rolling p99 (fed by the front's
  per-request observations) blows ``p99_budget_ms``, incoming requests are
  shed NEWEST-first (the request being judged is the newest): bulk
  immediately, interactive only past ``hard_shed_factor`` × the budget.

Every decision lands in ``synapseml_fleet_admitted_total{model,priority}``
/ ``synapseml_fleet_shed_total{model,priority,reason}`` and in plain
monotonic counters (:meth:`AdmissionController.stats`) the acceptance tests
reconcile against client-observed outcomes.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

from ..core import observability as obs
from .spec import AdmissionPolicy

__all__ = ["TokenBucket", "AdmissionDecision", "AdmissionController",
           "PRIORITIES", "priority_of"]

PRIORITIES = ("interactive", "bulk")

_ADMIT_METRICS = obs.HandleCache(lambda reg: {
    "admitted": reg.counter(
        "synapseml_fleet_admitted_total",
        "requests admitted by the fleet admission controller",
        ("model", "priority")),
    "shed": reg.counter(
        "synapseml_fleet_shed_total",
        "requests shed (429) by the fleet admission controller",
        ("model", "priority", "reason")),
})


def priority_of(headers) -> str:
    """Priority class of a request from its headers (``X-Priority: bulk``
    marks bulk-scoring traffic; everything else is interactive)."""
    try:
        v = headers.get("X-Priority") or headers.get("x-priority") or ""
    except AttributeError:
        return "interactive"
    return "bulk" if str(v).strip().lower() == "bulk" else "interactive"


class TokenBucket:
    """Monotonic-clock token bucket: ``burst`` capacity refilled at
    ``rate_per_s``. ``try_take(n, floor=f)`` spends only when at least
    ``f`` tokens would REMAIN — the priority-reserve primitive (bulk takes
    with ``floor = reserve × burst``, interactive with ``floor = 0``).
    ``clock`` is injectable so tests drive refills without sleeping."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError(f"rate_per_s and burst must be > 0: "
                             f"{rate_per_s}/{burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens

    def try_take(self, n: float = 1.0, floor: float = 0.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens - n < floor:
                return False
            self._tokens -= n
            return True

    def wait_time_s(self, n: float = 1.0, floor: float = 0.0) -> float:
        """Seconds until ``try_take(n, floor)`` could succeed (0 if now)."""
        with self._lock:
            self._refill(self._clock())
            deficit = (floor + n) - self._tokens
        return max(deficit / self.rate, 0.0)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """The front's verdict on one request. ``retry_after_s`` feeds the
    HTTP ``Retry-After`` header on a shed (429) reply."""

    admitted: bool
    status: int = 200
    retry_after_s: float = 0.0
    reason: str = ""


_ADMITTED = AdmissionDecision(True)


class _ModelAdmission:
    """Per-model mutable state: the bucket, the latency window, counters."""

    __slots__ = ("policy", "bucket", "latencies", "counts", "lock",
                 "last_observed_at")

    def __init__(self, policy: AdmissionPolicy, clock):
        self.policy = policy
        self.bucket = (TokenBucket(policy.rate_rps, policy.burst, clock)
                       if policy.rate_rps else None)
        self.latencies = collections.deque(maxlen=int(policy.latency_window))
        self.last_observed_at: float | None = None
        # monotonic counters the tests reconcile against client outcomes
        self.counts = {(p, "admitted"): 0 for p in PRIORITIES}
        self.counts.update({(p, "shed"): 0 for p in PRIORITIES})
        self.lock = threading.Lock()

    def p99_ms(self) -> float | None:
        with self.lock:
            lat = sorted(self.latencies)
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(len(lat) * 0.99))]


class AdmissionController:
    """Per-model admission decisions for a :class:`~synapseml_torch.io.
    distributed_serving.RoutingFront` (installed via
    ``front.set_admission(controller)``; the front calls :meth:`admit`
    before routing and :meth:`observe` after each forwarded reply).

    ``policies`` maps model name -> :class:`AdmissionPolicy`; ``default``
    applies to models without an entry (``None`` = unknown models pass
    unthrottled). Build one from a spec with :meth:`from_spec`."""

    def __init__(self, policies: dict[str, AdmissionPolicy] | None = None,
                 default: AdmissionPolicy | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._default = default
        self._models: dict[str, _ModelAdmission] = {}
        self._lock = threading.Lock()
        for model, policy in (policies or {}).items():
            if policy is not None:
                self._models[model] = _ModelAdmission(policy, clock)

    @classmethod
    def from_spec(cls, spec, default: AdmissionPolicy | None = None,
                  clock: Callable[[], float] = time.monotonic
                  ) -> "AdmissionController":
        return cls(spec.admission_policies(), default=default, clock=clock)

    # default-policy state is created on demand from the CLIENT-controlled
    # model string — cap it so a path scanner cannot grow per-model buckets
    # / latency windows / metric labels forever (models past the cap share
    # one overflow state, which still rate-limits them collectively)
    _MAX_DEFAULT_MODELS = 512

    def _state(self, model: str) -> _ModelAdmission | None:
        state = self._models.get(model)
        if state is not None:
            return state
        if self._default is None:
            return None
        with self._lock:
            state = self._models.get(model)
            if state is None:
                if len(self._models) >= self._MAX_DEFAULT_MODELS:
                    state = self._models.get("_overflow")
                    if state is None:
                        state = self._models["_overflow"] = \
                            _ModelAdmission(self._default, self._clock)
                else:
                    state = self._models[model] = _ModelAdmission(
                        self._default, self._clock)
            return state

    # -- the decision ------------------------------------------------------
    def admit(self, model: str,
              priority: str = "interactive") -> AdmissionDecision:
        prio = "bulk" if str(priority).lower() == "bulk" else "interactive"
        state = self._state(model)
        m = _ADMIT_METRICS.get()
        if state is None:
            # no policy and no default: pass through UNCOUNTED — the model
            # string is client-controlled path data, and a counter label
            # per random probe would grow the metric family forever
            return _ADMITTED
        # the metric label is bounded the same way the state map is: a
        # model collapsed into the overflow slot must not mint a fresh
        # Prometheus label (registry children live forever)
        if model not in self._models:
            model = "_overflow"
        pol = state.policy
        decision = None
        # p99 budget first: shedding here is what keeps the SLO — a request
        # that would be admitted into an already-blown queue only deepens it
        if pol.p99_budget_ms:
            p99 = state.p99_ms()
            # shed requests never reach a worker, so they never feed the
            # latency window — without a probe, a once-blown p99 would shed
            # EVERYTHING forever. When no observation has landed within
            # retry_after_s, admit the request as a probe instead: its
            # latency refreshes the window and a recovered model reopens.
            now = self._clock()
            with state.lock:
                last = state.last_observed_at
                stale = last is None or now - last >= pol.retry_after_s
                if p99 is not None and p99 > pol.p99_budget_ms and stale:
                    # grant ONE probe per window: stamping the grant time
                    # makes the next retry_after_s non-stale, so a slow
                    # probe (latency >> retry_after_s) cannot open the
                    # gate to the whole offered load while it runs
                    state.last_observed_at = now
            if p99 is not None and p99 > pol.p99_budget_ms and not stale:
                if prio == "bulk" or \
                        p99 > pol.hard_shed_factor * pol.p99_budget_ms:
                    decision = AdmissionDecision(
                        False, 429, pol.retry_after_s, "p99_budget")
        if decision is None and state.bucket is not None:
            floor = (pol.interactive_reserve * state.bucket.burst
                     if prio == "bulk" else 0.0)
            if not state.bucket.try_take(1.0, floor=floor):
                decision = AdmissionDecision(
                    False, 429,
                    max(state.bucket.wait_time_s(1.0, floor=floor), 0.05),
                    "rate")
        if decision is None:
            decision = _ADMITTED
        verdict = "admitted" if decision.admitted else "shed"
        with state.lock:
            state.counts[(prio, verdict)] += 1
        if decision.admitted:
            m["admitted"].inc(model=model, priority=prio)
        else:
            m["shed"].inc(model=model, priority=prio,
                          reason=decision.reason)
        return decision

    def observe(self, model: str, latency_ms: float, ok: bool = True) -> None:
        """Feed one served request's latency into the model's p99 window
        (the front calls this after every forwarded reply). FAILED replies
        stamp the freshness clock but do NOT enter the window: a saturated
        fleet shedding fast queue-full 503s would otherwise fill the window
        with millisecond failure latencies, drop the computed p99 below
        budget, and reopen admission into the very overload being shed."""
        state = self._models.get(model)
        if state is None and self._default is not None:
            # a model folded into the overflow slot at admit() time must
            # feed the SAME state, or p99 shedding (and the probe clock)
            # would be silently inert for every over-cap model
            state = self._models.get("_overflow")
        if state is None:
            return
        with state.lock:
            if ok:
                state.latencies.append(float(latency_ms))
            state.last_observed_at = self._clock()

    # -- introspection -----------------------------------------------------
    def p99_ms(self, model: str) -> float | None:
        state = self._models.get(model)
        return state.p99_ms() if state is not None else None

    def stats(self) -> dict:
        """Per-model monotonic admitted/shed counters + current p99 — the
        reconciliation surface for tests and the autoscaler's shed signal."""
        out: dict = {}
        for model, state in list(self._models.items()):
            with state.lock:
                counts = dict(state.counts)
            out[model] = {
                "admitted": {p: counts[(p, "admitted")] for p in PRIORITIES},
                "shed": {p: counts[(p, "shed")] for p in PRIORITIES},
                "p99_ms": state.p99_ms(),
                "tokens": (round(state.bucket.tokens, 3)
                           if state.bucket is not None else None),
            }
        return out
