"""VectorIndexModel: the servable sharded vector index stage.

Counterpart of ``synapseml_tpu/retrieval/model.py``. A published index is a
registry artifact: the stage's simple params carry the shard roster (names,
dim, metric), the shard data rides the artifact tree under ``shards/``, and
``core.serialization.load_stage`` hands the materialized artifact directory
to ``_artifact_dir``, so shards load on first touch. A shard loads once and
stays resident on the stage's device (vectors and norms; the ids and
payloads stay on the host, where the matches are assembled). Each shard is
scored through the shared :mod:`~synapseml_torch.retrieval.scorer`: query
batches ride the bucket ladder and callables are keyed by shard shape.

Serving rows carry a parsed JSON ``body``::

    {"queries": [[...], ...] | "query": [...], "k": 10, "shards": [names]}

and the reply column holds ``{"matches": [[{id, distance, payload, shard},
...] per query], "shards": [...], "scoring_ms": ...}``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.device import resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Model
from . import scorer
from . import shards as _shards
from .metrics import retrieval_metrics

__all__ = ["VectorIndexModel"]


class VectorIndexModel(Model):
    """Top-k search over a roster of immutable :class:`IndexShard`s."""

    feature_name = "retrieval"

    index_name = Param("index_name", "published index name (metric label)",
                       default="index")
    shard_names = Param("shard_names", "committed shard roster, name-sorted",
                        default=None)
    dim = Param("dim", "vector dimensionality", default=0,
                converter=TypeConverters.to_int)
    metric = Param("metric", "distance metric: 'l2' or 'cosine' (cosine "
                   "indexes store L2-normalized vectors; queries are "
                   "normalized host-side)", default="l2")
    k = Param("k", "neighbors returned per query", default=10,
              converter=TypeConverters.to_int)
    query_batch = Param("query_batch", "padded query rows per device batch",
                        default=256, converter=TypeConverters.to_int)
    output_col = Param("output_col", "reply column", default="reply")
    inline_shards = ComplexParam(
        "inline_shards", "in-memory shard dict name -> {name, vectors, ids, "
        "payloads} (tests / small indexes; real indexes ride the artifact "
        "tree)", default=None)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda")

    def set(self, **kw):
        out = super().set(**kw)
        if {"device", "inline_shards"} & kw.keys():
            self._drop_resident()
        return out

    def _drop_resident(self) -> None:
        self.__dict__.pop("_resident", None)
        self.__dict__.pop("_resident_nbytes", None)

    # -- shard residency ----------------------------------------------------
    def attach(self, shards_root: str) -> "VectorIndexModel":
        """Point the model at an explicit ``shards/`` directory (builds and
        tests; a registry-resolved artifact wires ``_artifact_dir``)."""
        self.__dict__["_shards_root"] = shards_root
        self._drop_resident()
        return self

    def shards_root(self) -> str | None:
        root = self.__dict__.get("_shards_root")
        if root:
            return root
        art = getattr(self, "_artifact_dir", None)
        if art:
            return os.path.join(art, "shards")
        return None

    def _shard_data(self, name: str):
        """(X, x_sq, ids, payloads) of one shard, loaded once: X and x_sq on
        the stage's device (their bytes in
        ``synapseml_retrieval_resident_shard_bytes``), ids and payloads on
        the host."""
        resident = self.__dict__.setdefault("_resident", {})
        entry = resident.get(name)
        if entry is not None:
            return entry
        device = resolve_device("VectorIndexModel", self.get("device"))
        inline = self.get("inline_shards") or {}
        if name in inline:
            rec = inline[name]
            vectors = rec["vectors"]
            n = len(vectors)
            ids = (np.asarray(rec["ids"], np.int64) if rec.get("ids") is not None
                   else np.arange(n, dtype=np.int64))
            payloads = rec.get("payloads")
        else:
            root = self.shards_root()
            if root is None:
                raise ValueError(
                    f"shard {name!r} is not inline and no shards root is "
                    "attached (load via the registry, or call attach())")
            sh = _shards.open_shard(os.path.join(root, name))
            vectors = sh.vectors()
            ids = sh.ids()
            payloads = sh.payloads()
        X = scorer._on(vectors, device)
        with torch.inference_mode():
            x_sq = torch.sum(X * X, dim=1)
        entry = (X, x_sq, ids, payloads)
        resident[name] = entry
        nbytes = X.nbytes + x_sq.nbytes
        self.__dict__["_resident_nbytes"] = (
            self.__dict__.get("_resident_nbytes", 0) + nbytes)
        retrieval_metrics()["resident_bytes"].set(
            self.__dict__["_resident_nbytes"], index=self.get("index_name"))
        return entry

    # -- search --------------------------------------------------------------
    def search(self, queries, k: int | None = None,
               shard_names: list[str] | None = None) -> list[list[dict]]:
        """Global top-k per query over ``shard_names`` (default: the whole
        roster): one match list per query, each match ``{"id", "distance"
        (sqrt L2), "payload", "shard"}``, sorted by ``(distance, id)``, so
        that the answer does not depend on how the index is sharded."""
        Q = np.asarray(queries, np.float32)
        if Q.ndim == 1:
            Q = Q[None, :]
        k = int(k if k is not None else self.get("k"))
        names = (list(shard_names) if shard_names is not None
                 else list(self.get("shard_names") or []))
        if self.get("metric") == "cosine":
            Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)
        per_query: list[list[dict]] = [[] for _ in range(len(Q))]
        t0 = time.perf_counter()
        for nm in names:
            X, x_sq, ids, payloads = self._shard_data(nm)
            kk = min(k, X.shape[0])
            if kk == 0:
                continue
            dist, idx = scorer.score_batches(
                Q, X, kk, x_sq=x_sq, query_batch=self.get("query_batch"))
            for i in range(len(Q)):
                row = per_query[i]
                for d, j in zip(dist[i], idx[i]):
                    row.append({
                        "id": int(ids[j]),
                        "distance": float(np.sqrt(max(float(d), 0.0))),
                        "payload": payloads[j] if payloads is not None else None,
                        "shard": nm,
                    })
        for i, row in enumerate(per_query):
            row.sort(key=lambda m: (m["distance"], m["id"]))
            per_query[i] = row[:k]
        m = retrieval_metrics()
        label = self.get("index_name")
        m["queries"].inc(len(Q), index=label)
        m["shard_ms"].observe((time.perf_counter() - t0) * 1000.0, index=label)
        return per_query

    # -- serving -------------------------------------------------------------
    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, "body")

        def per_part(p):
            bodies = p["body"]
            replies = np.empty(len(bodies), dtype=object)
            for i, b in enumerate(bodies):
                if not isinstance(b, dict):
                    b = json.loads(b)
                qs = b.get("queries")
                if qs is None and "query" in b:
                    qs = [b["query"]]
                if qs is None:
                    replies[i] = {"error": "body needs 'queries' or 'query'"}
                    continue
                k = int(b.get("k") or self.get("k"))
                names = b.get("shards")
                t0 = time.perf_counter()
                matches = self.search(np.asarray(qs, np.float32), k=k,
                                      shard_names=names)
                replies[i] = {
                    "matches": matches,
                    "shards": list(names if names is not None
                                   else self.get("shard_names") or []),
                    "scoring_ms": (time.perf_counter() - t0) * 1000.0,
                }
            q = dict(p)
            q[self.get("output_col")] = replies
            return q

        return df.map_partitions(per_part)
