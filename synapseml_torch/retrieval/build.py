"""Index build: embedding backfill -> immutable shards -> published artifact.

Counterpart of ``synapseml_tpu/retrieval/build.py``. The backfill is a bulk
scoring job: any vector-producing stage (``HuggingFaceSentenceEmbedder`` on
the card, the dependency-free :class:`HashEmbedder` below on the host) runs
over a ``ShardedSource`` corpus through ``scoring.transform_source`` into an
``NpySink`` (exactly once, resumable, quarantining), and each completed
part becomes one immutable :class:`~synapseml_torch.retrieval.shards.IndexShard`.
``publish_index`` rides ``ModelRegistry.publish(extra_tree=...)``: the shard
files become content-addressed blobs of the manifest, so an index version
is pinned, aliased and collected like model weights, and unchanged shards
dedupe across versions. The published :class:`VectorIndexModel` searches
on its ``device`` ("cuda" unless the caller asks for "cpu").
"""

from __future__ import annotations

import os

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from .model import VectorIndexModel
from .shards import IndexShard, list_shards, write_shard

__all__ = ["HashEmbedder", "embed_corpus", "shards_from_parts",
           "publish_index", "build_index"]


class HashEmbedder(Transformer):
    """Deterministic feature-hashing text embedder (pure numpy, zero model
    weights) — the corpus-scale stand-in for
    ``hf.HuggingFaceSentenceEmbedder`` in tests and the CPU bench arms.
    Tokens hash to a signed coordinate (the classic hashing trick), so the
    same text always embeds to the same vector in any process."""

    feature_name = "retrieval"

    text_col = Param("text_col", "input text column", default="text")
    output_col = Param("output_col", "embedding column", default="embedding")
    dim = Param("dim", "embedding dimensionality", default=64,
                converter=TypeConverters.to_int)
    seed = Param("seed", "hash seed (a different seed is a different "
                 "embedding space)", default=0, converter=TypeConverters.to_int)
    normalize = Param("normalize", "L2-normalize embeddings (cosine indexes)",
                      default=False, converter=TypeConverters.to_bool)

    def embed(self, texts) -> np.ndarray:
        import hashlib

        dim = self.get("dim")
        seed = self.get("seed")
        out = np.zeros((len(texts), dim), np.float32)
        for i, t in enumerate(texts):
            for tok in str(t).lower().split():
                h = hashlib.md5(f"{seed}:{tok}".encode()).digest()
                j = int.from_bytes(h[:4], "little") % dim
                out[i, j] += 1.0 if h[4] & 1 else -1.0
        if self.get("normalize"):
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
        return out

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("text_col"))

        def per_part(p):
            q = dict(p)
            q[self.get("output_col")] = self.embed(list(p[self.get("text_col")]))
            return q

        return df.map_partitions(per_part)


def embed_corpus(stage, source, sink_dir: str, *,
                 vector_col: str = "embedding", id_col: str = "id",
                 batch_rows: int = 256, **transform_kw):
    """Run the embedding backfill: ``stage`` over ``source`` into an
    ``NpySink`` at ``sink_dir`` carrying ``[vector_col, id_col]``. Returns
    ``(sink, report)``. Exactly-once: a re-run (crash resume) skips
    DONE-committed parts, so the sink bytes are identical to an
    uninterrupted run."""
    from ..scoring import NpySink, transform_source

    sink = NpySink(sink_dir, columns=[vector_col, id_col])
    report = transform_source(stage, source, sink, batch_rows=batch_rows,
                              **transform_kw)
    return sink, report


def shards_from_parts(sink, index_dir: str, *,
                      vector_col: str = "embedding", id_col: str = "id",
                      payload_fn=None, prefix: str = "base",
                      kind: str = "base") -> list[IndexShard]:
    """One immutable shard per completed sink part, committed atomically
    under ``index_dir/shards/<prefix>-NNNNN``. Idempotent: already-committed
    shards are kept as-is (byte-identical resume). ``payload_fn(id)``
    (optional) supplies each row's returned payload — payloads are
    non-numeric, so they ride the shard sidecar, not the npy sink."""
    shards_dir = os.path.join(index_dir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    out = []
    done = sink.completed()
    for i in sorted(done):
        stem = sink.part_stem(i)
        vec_name = f"{stem}.{vector_col}.npy"
        if vec_name not in done[i]["files"]:
            continue  # zero-row part (every row quarantined)
        vectors = np.load(os.path.join(sink.path, vec_name))
        if not vectors.shape[0]:
            continue
        ids = np.asarray(np.load(os.path.join(
            sink.path, f"{stem}.{id_col}.npy")), np.int64)
        payloads = ([payload_fn(int(d)) for d in ids]
                    if payload_fn is not None else None)
        out.append(write_shard(shards_dir, f"{prefix}-{i:05d}", vectors,
                               ids=ids, payloads=payloads, kind=kind))
    return out


def index_model_for(index_dir: str, *, name: str = "index",
                    metric: str = "l2", k: int = 10,
                    query_batch: int = 256, device: str = "cuda") -> VectorIndexModel:
    """A :class:`VectorIndexModel` over the committed shards of
    ``index_dir`` (roster read from disk, data attached lazily) that
    searches on ``device``."""
    committed = list_shards(os.path.join(index_dir, "shards"))
    if not committed:
        raise ValueError(f"no committed shards under {index_dir!r}")
    dims = {s.dim for s in committed}
    if len(dims) != 1:
        raise ValueError(f"mixed shard dims {sorted(dims)} under {index_dir!r}")
    model = VectorIndexModel(index_name=name,
                             shard_names=[s.name for s in committed],
                             dim=dims.pop(), metric=metric, k=k,
                             query_batch=query_batch, device=device)
    return model.attach(os.path.join(index_dir, "shards"))


def publish_index(registry, name: str, index_dir: str, *,
                  metric: str = "l2", k: int = 10, query_batch: int = 256,
                  version: str | None = None, set_latest: bool = True,
                  metrics: dict | None = None, device: str = "cuda"):
    """Publish ``index_dir`` (its ``shards/`` tree) as registry artifact
    ``name``: the stage is a :class:`VectorIndexModel` carrying the shard
    roster, ``extra_tree`` rides the shard files into the content-addressed
    manifest, and the manifest's ``extra.retrieval`` section records the
    roster + row counts for operators. Returns the ``PublishedVersion``."""
    model = index_model_for(index_dir, name=name, metric=metric, k=k,
                            query_batch=query_batch, device=device)
    committed = list_shards(os.path.join(index_dir, "shards"))
    extra = {"retrieval": {
        "shards": [{"name": s.name, "rows": s.rows, "kind": s.kind}
                   for s in committed],
        "rows": int(sum(s.rows for s in committed)),
        "dim": int(committed[0].dim),
        "metric": metric,
    }}
    return registry.publish(name, model, version=version, metrics=metrics,
                            extra=extra, set_latest=set_latest,
                            extra_tree=index_dir)


def build_index(registry, name: str, stage, source, work_dir: str, *,
                vector_col: str = "embedding", id_col: str = "id",
                payload_fn=None, metric: str = "l2", k: int = 10,
                batch_rows: int = 256, version: str | None = None,
                device: str = "cuda", **transform_kw):
    """The whole v1 pipeline: backfill -> shards -> publish. Returns
    ``(published, report)``."""
    sink, report = embed_corpus(stage, source, os.path.join(work_dir, "emb"),
                                vector_col=vector_col, id_col=id_col,
                                batch_rows=batch_rows, **transform_kw)
    index_dir = os.path.join(work_dir, "index")
    shards_from_parts(sink, index_dir, vector_col=vector_col, id_col=id_col,
                      payload_fn=payload_fn)
    published = publish_index(registry, name, index_dir, metric=metric, k=k,
                              version=version, device=device)
    return published, report
