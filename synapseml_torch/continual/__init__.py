"""Closed-loop continual training: the serve->log->retrain->canary flywheel.

Counterpart of ``synapseml_tpu/continual/``:

* :class:`RequestLogger` (``logger.py``): a sampled, SLO-safe,
  PII-scrubbed request/response logger hooked into ``RoutingFront`` /
  ``ServingServer`` that appends jsonl shards in ``ShardedSource`` layout
  with atomic part/DONE commits; :func:`logged_request_source` reads the
  committed parts back;
* :class:`TrainSupervisor` (``supervisor.py``): crash-safe long fits, with
  bounded restarts from the latest verified checkpoint, a hang watchdog on
  checkpoint progress (subprocess mode), a NaN rewind that skips the
  poisoned batch window, and a separate budget for gang preemptions;
* :class:`ContinualLoop` (``loop.py``): one :class:`ContinualSpec` driving
  watch -> warm-started fit -> eval gate against prod on a held-out slice
  -> ``registry.publish`` -> canary with auto-rollback, every seam
  consulting the active ``FaultPlan`` and every outcome on the
  ``synapseml_continual_*`` series.
"""

from .logger import RequestLogger, logged_request_source
from .loop import (ContinualLoop, ContinualSpec, LoopAborted, annotate_drift_gauge,
                   drift_annotation)
from .supervisor import TrainAttempt, TrainSupervisor

__all__ = [
    "ContinualLoop",
    "ContinualSpec",
    "LoopAborted",
    "RequestLogger",
    "TrainAttempt",
    "TrainSupervisor",
    "annotate_drift_gauge",
    "drift_annotation",
    "logged_request_source",
]
