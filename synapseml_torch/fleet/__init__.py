"""Fleet control plane: elastic autoscaling, multi-model residency, and
admission control for the serving tier.

Counterpart of ``synapseml_tpu/fleet/``: the control loop over the serving
planes, driven by one declarative :class:`~synapseml_torch.fleet.spec.
FleetSpec`:

* :mod:`.autoscaler` — :class:`FleetAutoscaler` reconciles live workers
  against per-model SLO targets (queue depth, routed p95) through a
  pluggable :class:`WorkerLauncher`; scale-up workers ``/admin/load`` their
  registry ref, scale-down workers drain gracefully (``POST /admin/drain``:
  finish the backlog, deregister, exit), and crashed workers are replaced
  within one reconcile interval. A subprocess worker is a fresh interpreter
  that serves on its stages' ``device``;
* :mod:`.residency` — :class:`ResidencyManager` packs N registry models
  onto one worker behind per-model ``PipelineHolder`` slots with a
  byte-budgeted LRU; eviction releases the model's cached callables, page
  pools and built module, giving its device memory back, and
  :func:`serve_multi_model` routes request rows by the ``/m/<model>`` path
  segment;
* :mod:`.admission` — :class:`AdmissionController` puts per-model token
  buckets, priority classes (interactive > bulk), and newest-first
  p99-budget load shedding (429 + ``Retry-After``) on the routing front.

Everything exports as ``synapseml_fleet_*`` series plus a
``fleet.reconcile`` span.
"""

from .spec import AdmissionPolicy, FleetSpec, ModelSLO
from .admission import (AdmissionController, AdmissionDecision, TokenBucket,
                        priority_of)
from .residency import (ResidencyManager, artifact_nbytes, model_from_path,
                        model_path, serve_multi_model)
from .autoscaler import (FleetAutoscaler, FleetSignals,
                         SubprocessWorkerLauncher, ThreadWorkerLauncher,
                         WorkerHandle, WorkerLauncher, fleet_worker_main)

__all__ = [
    "FleetSpec",
    "ModelSLO",
    "AdmissionPolicy",
    "AdmissionController",
    "AdmissionDecision",
    "TokenBucket",
    "priority_of",
    "ResidencyManager",
    "serve_multi_model",
    "model_path",
    "model_from_path",
    "artifact_nbytes",
    "FleetAutoscaler",
    "FleetSignals",
    "WorkerLauncher",
    "WorkerHandle",
    "ThreadWorkerLauncher",
    "SubprocessWorkerLauncher",
    "fleet_worker_main",
]
