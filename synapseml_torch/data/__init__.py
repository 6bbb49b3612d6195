"""Streaming data plane: sharded sources, a prefetching loader with
seeded shuffles, and resumable iterator state.

Counterpart of ``synapseml_tpu/data/``:

* :mod:`.source`: :class:`ShardedSource` and :class:`MemorySource`;
* :mod:`.loader`: :class:`DataLoader`, deterministic seeded shard and row
  shuffles, batches through the ``core/batching`` bucket ladder, a
  bounded-queue background prefetcher;
* :mod:`.state`: :class:`IteratorState`, the cursors a loader resumes from.

Training entry points: ``models.trainer.fit_source`` and ``fit_arrays``.
"""

from .loader import DataLoader  # noqa: F401
from .source import MemorySource, Shard, ShardedSource  # noqa: F401
from .state import IteratorState, row_order, shard_order  # noqa: F401

__all__ = ["DataLoader", "MemorySource", "Shard", "ShardedSource",
           "IteratorState", "row_order", "shard_order"]
