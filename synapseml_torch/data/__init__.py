"""Streaming data plane: sharded sources, a prefetching loader with
seeded shuffles, and resumable iterator state.

Counterpart of ``synapseml_tpu/data/``:

* :mod:`.source`: :class:`ShardedSource` and :class:`MemorySource`;
* :mod:`.loader`: :class:`DataLoader`, deterministic seeded shard and row
  shuffles, batches through the ``core/batching`` bucket ladder, a
  bounded-queue background prefetcher;
* :mod:`.state`: :class:`IteratorState`, the cursors a loader resumes from;
  :class:`ElasticPlan`, a gang's frozen virtual streams, which
  :class:`ElasticStreamSet` (:mod:`.loader`) serves on any survivor count.

Training entry points: ``models.trainer.fit_source``, ``fit_arrays`` and
``fit_gang_source``.
"""

from .loader import DataLoader, ElasticStreamSet  # noqa: F401
from .source import MemorySource, Shard, ShardedSource  # noqa: F401
from .state import ElasticPlan, IteratorState, row_order, shard_order  # noqa: F401

__all__ = ["DataLoader", "ElasticStreamSet", "MemorySource", "Shard", "ShardedSource",
           "ElasticPlan", "IteratorState", "row_order", "shard_order"]
