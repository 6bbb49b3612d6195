"""Retrieval-plane metric handles (``synapseml_retrieval_*`` series).

Counterpart of ``synapseml_tpu/retrieval/metrics.py``: one HandleCache per
process on the default observability registry. Series:

* ``synapseml_retrieval_queries_total{index}`` — query vectors scored (QPS)
* ``synapseml_retrieval_shard_scoring_ms{index}`` — per-request worker-side
  shard scoring wall
* ``synapseml_retrieval_merge_ms{index}`` — front-side fan-out + top-k
  merge wall
* ``synapseml_retrieval_shard_coverage{index}`` — scored/expected shard
  fraction per fan-out (the recall proxy: 1.0 = exact)
* ``synapseml_retrieval_partial_total{index}`` — fan-outs answered with
  ``X-Retrieval-Partial``
* ``synapseml_retrieval_freshness_lag_s{index}`` — logged-doc to queryable
  lag measured at delta-shard publish
* ``synapseml_retrieval_resident_shard_bytes{index}`` — shard bytes this
  process holds resident on the index's device (vectors and norms)
"""

from __future__ import annotations

from ..core import observability as obs

__all__ = ["retrieval_metrics"]

_RETRIEVAL_METRICS = obs.HandleCache(lambda reg: {
    "queries": reg.counter(
        "synapseml_retrieval_queries_total",
        "query vectors scored through the retrieval plane", ("index",)),
    "shard_ms": reg.histogram(
        "synapseml_retrieval_shard_scoring_ms",
        "worker-side shard scoring wall per request", ("index",)),
    "merge_ms": reg.histogram(
        "synapseml_retrieval_merge_ms",
        "front-side fan-out + global top-k merge wall", ("index",)),
    "coverage": reg.histogram(
        "synapseml_retrieval_shard_coverage",
        "scored/expected shard fraction per fan-out (recall proxy)",
        ("index",)),
    "partial": reg.counter(
        "synapseml_retrieval_partial_total",
        "fan-outs degraded to partial results (X-Retrieval-Partial)",
        ("index",)),
    "freshness": reg.gauge(
        "synapseml_retrieval_freshness_lag_s",
        "logged-document to queryable lag at delta publish", ("index",)),
    "resident_bytes": reg.gauge(
        "synapseml_retrieval_resident_shard_bytes",
        "shard bytes resident in this process", ("index",)),
})


def retrieval_metrics() -> dict:
    """The per-registry handle dict (create-on-first-use)."""
    return _RETRIEVAL_METRICS.get()
