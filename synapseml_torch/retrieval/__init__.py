"""Retrieval: a sharded vector index with continual ingest.

Counterpart of ``synapseml_tpu/retrieval/``:

* **build**: the embedding backfill is a ``scoring.transform_source`` job;
  DONE-gated ``NpySink`` parts become immutable :class:`IndexShard`s, and
  ``publish_index`` rides the registry's content-addressed blob store;
* **search**: :class:`VectorIndexModel` scores each shard, resident on its
  device, through the one shared matmul and top-k (:mod:`.scorer`, also
  the engine of ``nn/knn.py``) on the bucket ladder, and merges the
  per-shard top-k by ``(distance, id)``;
* **ingest**: freshly logged documents embed and commit as new delta shards
  under the next version, with no rebuild; ``compact_index`` folds deltas
  past a threshold;
* **serve**: :func:`retrieval_worker_main` runs byte-budgeted
  ``ResidencyManager`` holders behind ``/m/<index>``, each advertising its
  shards; the ``RoutingFront`` fans a query to them and merges the
  per-shard top-k (missing shards degrade to partial results with
  ``X-Retrieval-Partial``, never 500s);
* **observe**: the ``synapseml_retrieval_*`` series (:mod:`.metrics`).

Submodules import lazily (PEP 562): ``nn/knn.py`` pulls only the scorer
without dragging the fleet/registry serve chain into every KNN import.
"""

from __future__ import annotations

import importlib

__all__ = [
    "INF", "score_shard", "score_batches",
    "IndexShard", "SHARD_MANIFEST", "write_shard", "open_shard",
    "list_shards",
    "VectorIndexModel",
    "HashEmbedder", "embed_corpus", "shards_from_parts", "index_model_for",
    "publish_index", "build_index",
    "ingest_deltas", "compact_index", "extract_documents",
    "retrieval_worker_main",
    "retrieval_metrics",
]

_LOCATIONS = {
    "INF": "scorer", "score_shard": "scorer", "score_batches": "scorer",
    "IndexShard": "shards", "SHARD_MANIFEST": "shards",
    "write_shard": "shards", "open_shard": "shards", "list_shards": "shards",
    "VectorIndexModel": "model",
    "HashEmbedder": "build", "embed_corpus": "build",
    "shards_from_parts": "build", "index_model_for": "build",
    "publish_index": "build", "build_index": "build",
    "ingest_deltas": "ingest", "compact_index": "ingest",
    "extract_documents": "ingest",
    "retrieval_worker_main": "serve",
    "retrieval_metrics": "metrics",
}


def __getattr__(name: str):
    submodule = _LOCATIONS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{submodule}", __name__), name)
    globals()[name] = value  # cache: one import, stable identity
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
