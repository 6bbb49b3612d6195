"""Fleet control plane: the routing front's admission policy.

Counterpart of ``synapseml_tpu/fleet/``. Ported so far:

* :mod:`.spec` — :class:`FleetSpec`, :class:`ModelSLO` and
  :class:`AdmissionPolicy`, plain data with a JSON round trip;
* :mod:`.admission` — :class:`AdmissionController`: per-model token
  buckets, priority classes (interactive > bulk) and newest-first
  p99-budget shedding (429 + ``Retry-After``) on the routing front
  (``io/distributed_serving.RoutingFront(admission=...)``);
* :mod:`.residency` — ``model_path`` / ``model_from_path``, the
  ``/m/<model>`` path convention.

The autoscaler (``FleetAutoscaler`` and its worker launchers),
``ResidencyManager``, ``serve_multi_model`` and ``artifact_nbytes`` wait
for the fleet slice (ROADMAP.md queue A item 10).
"""

from .spec import AdmissionPolicy, FleetSpec, ModelSLO
from .admission import (AdmissionController, AdmissionDecision, TokenBucket,
                        priority_of)
from .residency import model_from_path, model_path

__all__ = [
    "FleetSpec",
    "ModelSLO",
    "AdmissionPolicy",
    "AdmissionController",
    "AdmissionDecision",
    "TokenBucket",
    "priority_of",
    "model_path",
    "model_from_path",
]
