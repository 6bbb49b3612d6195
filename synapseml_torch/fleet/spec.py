"""Declarative fleet specification: per-model SLO targets + admission rules.

Counterpart of ``synapseml_tpu/fleet/spec.py``, copied whole. One
:class:`FleetSpec` is the control plane's whole configuration — what the
autoscaler reconciles toward (``fleet/autoscaler.py``), what the admission
controller enforces (``fleet/admission.py``), and what the residency budget
bounds (``fleet/residency.py``). The spec is plain data with a JSON round
trip, so a fleet's desired state can live in version control next to the
model registry it points at (the same declarative discipline the sharding
plane's rule tables follow).
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["AdmissionPolicy", "ModelSLO", "FleetSpec"]


@dataclasses.dataclass
class AdmissionPolicy:
    """Per-model admission rules (``fleet/admission.py`` enforces them).

    * ``rate_rps``/``burst`` — a token bucket on the routing front; ``None``
      disables rate limiting. ``burst`` defaults to ``2 * rate_rps``.
    * ``interactive_reserve`` — the fraction of the bucket bulk traffic may
      never spend into: bulk requests are refused while fewer than
      ``reserve * burst`` tokens remain, so a bulk-scoring flood can never
      starve interactive traffic of admission capacity.
    * ``p99_budget_ms`` — the latency SLO the shedder protects: when the
      model's observed p99 exceeds it, incoming (NEWEST-first — the request
      being judged is the newest) bulk requests are shed with 429 +
      ``Retry-After``; interactive requests are shed only past
      ``hard_shed_factor`` × the budget (total overload).
    """

    rate_rps: float | None = None
    burst: float | None = None
    p99_budget_ms: float | None = None
    interactive_reserve: float = 0.2
    hard_shed_factor: float = 2.0
    retry_after_s: float = 1.0
    latency_window: int = 256

    def __post_init__(self):
        if self.burst is None and self.rate_rps is not None:
            self.burst = 2.0 * float(self.rate_rps)
        if not 0.0 <= float(self.interactive_reserve) < 1.0:
            raise ValueError(f"interactive_reserve must be in [0, 1): "
                             f"{self.interactive_reserve}")
        if float(self.hard_shed_factor) < 1.0:
            raise ValueError(f"hard_shed_factor must be >= 1: "
                             f"{self.hard_shed_factor}")
        if self.rate_rps is not None \
                and (1.0 - self.interactive_reserve) * self.burst < 1.0:
            # bulk needs a full token ABOVE the reserve floor; a config
            # where that can never happen silently blackholes bulk forever
            raise ValueError(
                f"(1 - interactive_reserve) * burst must be >= 1 or bulk "
                f"traffic can never be admitted: reserve="
                f"{self.interactive_reserve}, burst={self.burst} — raise "
                f"burst or lower the reserve")


@dataclasses.dataclass
class ModelSLO:
    """One model's serving targets — the autoscaler's reconcile input.

    ``model`` is the registry name; ``ref`` the version/alias spawned
    workers ``/admin/load``. Scale-up triggers when the mean per-worker
    queue depth exceeds ``target_queue_depth`` OR the model's routed p95
    exceeds ``p95_slo_ms``; scale-down needs ``scale_down_after``
    consecutive reconciles with MEASURED near-idle queues (<= 25% of
    target; p95 is deliberately not consulted — its rolling window decays
    too slowly to gate downs, and a no-signal pass never counts as idle) —
    asymmetric on purpose: up fast, down slow. ``serve`` holds
    per-model worker knobs passed to ``serve_pipeline`` (scheduler,
    ``batch_interval_ms``, ``max_batch_rows``, ...)."""

    model: str
    ref: str = "latest"
    min_workers: int = 1
    max_workers: int = 4
    target_queue_depth: float = 8.0
    p95_slo_ms: float | None = None
    scale_down_after: int = 3
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 10.0
    admission: AdmissionPolicy | None = None
    serve: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.min_workers < 0 or self.max_workers < 1 \
                or self.min_workers > self.max_workers:
            raise ValueError(
                f"{self.model}: need 0 <= min_workers <= max_workers "
                f"(>=1), got {self.min_workers}/{self.max_workers}")
        if isinstance(self.admission, dict):
            self.admission = AdmissionPolicy(**self.admission)


@dataclasses.dataclass
class FleetSpec:
    """The whole fleet's declared state: the models it serves (each a
    :class:`ModelSLO`), the reconcile cadence, and the per-worker residency
    byte budget for multi-model workers (``None`` = single-model workers,
    no eviction)."""

    models: list[ModelSLO]
    reconcile_interval_s: float = 1.0
    byte_budget: int | None = None

    def __post_init__(self):
        self.models = [m if isinstance(m, ModelSLO) else ModelSLO(**m)
                       for m in self.models]
        names = [m.model for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in FleetSpec: {names}")

    def slo_for(self, model: str) -> ModelSLO | None:
        for m in self.models:
            if m.model == model:
                return m
        return None

    def admission_policies(self) -> dict[str, AdmissionPolicy]:
        return {m.model: m.admission for m in self.models
                if m.admission is not None}

    # -- JSON round trip (the spec lives in version control) ---------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        return cls(**json.loads(text))
