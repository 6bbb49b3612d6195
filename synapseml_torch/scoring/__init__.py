"""Bulk scoring: out-of-core ``transform_source`` with exactly-once sharded
sinks.

Counterpart of ``synapseml_tpu/scoring/``, Spark's ``transform()`` over any
size of DataFrame:

* :mod:`.planner`: per-host shard assignment (a strided disjoint exact
  cover) and bucket-ladder batch formation, so a corpus scan builds at most
  ladder-many callables per stage function in the shared ``CompiledCache``;
* :mod:`.sink`: sharded jsonl/npy sinks with atomic write-then-rename part
  files, per-shard DONE markers, an append-only per-host cursor and an
  errors sidecar, so that kill and resume emit each input row once;
* :mod:`.runner`: :func:`~synapseml_torch.scoring.runner.transform_source`,
  a bounded-queue pipeline of shard reads, ``stage.transform`` batches on
  the stage's device and sink writes, with the ``synapseml_scoring_*``
  series, retried reads and row and shard quarantine.

Every fitted ``Transformer`` and ``PipelineModel`` carries
``stage.transform_source(source, sink)`` (``core/pipeline.py``).
"""

from .planner import (ScoringPlan, assign_shards, iter_shard_batches,  # noqa: F401
                      plan_scan)
from .runner import (ScoringContractError, ScoringReport,  # noqa: F401
                     transform_source)
from .sink import JsonlSink, NpySink, ScoreSink, open_sink  # noqa: F401

__all__ = [
    "ScoringPlan", "assign_shards", "plan_scan", "iter_shard_batches",
    "transform_source", "ScoringReport", "ScoringContractError",
    "ScoreSink", "JsonlSink", "NpySink", "open_sink",
]
