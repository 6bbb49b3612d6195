"""Closed-loop continual training: the serve→log→retrain→canary flywheel.

Counterpart of ``synapseml_tpu/continual/``. Ported so far:

* :class:`RequestLogger` (``logger.py``) — a sampled, SLO-safe,
  PII-scrubbed request/response logger hooked into ``RoutingFront`` /
  ``ServingServer`` that appends jsonl shards in ``ShardedSource`` layout
  with atomic part/DONE commits, turning production traffic into a
  first-class training source; :func:`logged_request_source` reads the
  committed parts back.

``TrainSupervisor`` (``supervisor.py``) and ``ContinualLoop``
(``loop.py``) wait for gang training (ROADMAP.md queue A item 9), which
the supervisor imports.
"""

from .logger import RequestLogger, logged_request_source

__all__ = [
    "RequestLogger",
    "logged_request_source",
]
