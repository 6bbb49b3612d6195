"""Brute-force matmul KNN and conditional KNN.

Counterpart of ``synapseml_tpu/nn/knn.py`` (reference surface: ``KNN.scala``
and ``ConditionalKNN``, fitted on a features + values DataFrame; transform
adds a column of each query row's k best matches, the conditional one
restricted to rows whose label is in the query's allowed set).

Squared L2 distance decomposes as |q|^2 - 2 q.x + |x|^2, so the work is one
[Q, N] matmul and a top-k on the model's device, in fixed padded query
batches. Conditional filtering is an additive mask on the distances.
Scoring is the shared per-shard scorer of ``retrieval/scorer.py`` (the
index's engine), so KNN and ``VectorIndexModel`` cannot drift, ties
included: both select ``lax.top_k``'s ids (lowest index first).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.device import resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..retrieval.scorer import INF as _INF
from ..retrieval.scorer import _on
from ..retrieval.scorer import score_batches as _score_shard

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]

_DEVICE_DOC = "torch device: 'cuda' (default), 'cuda:N' or 'cpu'"


def _stack_features(col, dtype="float32"):
    """A vector column (rectangular array or object column of per-row
    vectors) as an [N, D] array (``synapseml_tpu/core/utils.py``'s
    ``stack_vector_column``)."""
    arr = np.asarray(col)
    if arr.dtype == object:
        if len(arr) == 0:
            return np.zeros((0, 0), dtype)
        arr = np.stack([np.asarray(v) for v in arr])
    return arr.astype(dtype)


class _KNNBase(Estimator):
    features_col = Param("features_col", "feature vector column", default="features")
    values_col = Param("values_col", "payload column returned with matches",
                       default="values")
    label_col = Param("label_col", "conditioner label column (conditional only)",
                      default="labels")
    output_col = Param("output_col", "matches column", default="output")
    k = Param("k", "number of neighbors", default=5, converter=TypeConverters.to_int)
    query_batch = Param("query_batch", "padded query rows per device batch",
                        default=256, converter=TypeConverters.to_int)
    device = Param("device", _DEVICE_DOC, default="cuda")


class KNN(_KNNBase):
    """(ref ``nn/KNN.scala:49``)"""

    feature_name = "nn"

    def _fit(self, df: DataFrame) -> "KNNModel":
        self.require_columns(df, self.get("features_col"), self.get("values_col"))
        X = _stack_features(df.collect_column(self.get("features_col")))
        vals = np.asarray(df.collect_column(self.get("values_col")))
        return KNNModel(index=X, values=vals,
                        features_col=self.get("features_col"),
                        output_col=self.get("output_col"),
                        k=self.get("k"), query_batch=self.get("query_batch"),
                        device=self.get("device"))


class KNNModel(Model):
    index = ComplexParam("index", "[N, D] indexed feature matrix")
    values = ComplexParam("values", "payload per indexed row")
    labels = ComplexParam("labels", "conditioner label per indexed row", default=None)
    features_col = Param("features_col", "feature vector column", default="features")
    output_col = Param("output_col", "matches column", default="output")
    k = Param("k", "number of neighbors", default=5, converter=TypeConverters.to_int)
    query_batch = Param("query_batch", "padded query rows per device batch",
                        default=256, converter=TypeConverters.to_int)
    device = Param("device", _DEVICE_DOC, default="cuda")

    def _match_bias(self, p, s: int, e: int) -> np.ndarray | None:
        """[e-s, N] additive bias (0 = allowed) for one query batch;
        None (plain KNN) means everything is allowed — no bias matrix is
        materialized or shipped to the device."""
        return None

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("features_col"))
        X = _on(self.get("index"), resolve_device(type(self).__name__, self.get("device")))
        x_sq = (X * X).sum(dim=1)
        vals = self.get("values")
        labels = self.get("labels")
        B = self.get("query_batch")
        k = self.get("k")

        def per_part(p):
            Q = _stack_features(p[self.get("features_col")])
            n = len(Q)
            matches = np.empty(n, dtype=object)
            # the shared retrieval scorer: ladder-bucketed query batches,
            # one cache entry per (bucket, index shape) across the process
            dist, idx = _score_shard(
                Q, X, k, x_sq=x_sq, query_batch=B,
                bias_fn=lambda s, e: self._match_bias(p, s, e))
            for i in range(n):
                row = []
                for d, j in zip(dist[i], idx[i]):
                    if d >= _INF / 2:  # filtered out (conditional)
                        continue
                    match = {"value": vals[j],
                             "distance": float(np.sqrt(max(d, 0.0))),
                             "index": int(j)}
                    if labels is not None:
                        match["label"] = labels[j]
                    row.append(match)
                matches[i] = row
            q = dict(p)
            q[self.get("output_col")] = matches
            return q

        return df.map_partitions(per_part)


class ConditionalKNN(_KNNBase):
    """(ref ``nn/ConditionalKNN.scala``) — neighbors restricted per query to
    rows whose label is in the query's ``conditioner`` set."""

    feature_name = "nn"

    conditioner_col = Param("conditioner_col", "column of allowed-label sets",
                            default="conditioner")

    def _fit(self, df: DataFrame) -> "ConditionalKNNModel":
        self.require_columns(df, self.get("features_col"), self.get("values_col"),
                             self.get("label_col"))
        X = _stack_features(df.collect_column(self.get("features_col")))
        vals = np.asarray(df.collect_column(self.get("values_col")))
        labels = np.asarray(df.collect_column(self.get("label_col")))
        return ConditionalKNNModel(index=X, values=vals, labels=labels,
                                   features_col=self.get("features_col"),
                                   output_col=self.get("output_col"),
                                   conditioner_col=self.get("conditioner_col"),
                                   k=self.get("k"), query_batch=self.get("query_batch"),
                                   device=self.get("device"))


class ConditionalKNNModel(KNNModel):
    conditioner_col = Param("conditioner_col", "column of allowed-label sets",
                            default="conditioner")

    def _match_bias(self, p, s: int, e: int) -> np.ndarray:
        labels = np.asarray(self.get("labels"))
        conds = p[self.get("conditioner_col")][s:e]
        bias = np.full((e - s, len(labels)), _INF, np.float32)
        for i in range(e - s):
            allowed = conds[i]
            allowed = {allowed} if np.isscalar(allowed) else set(np.asarray(allowed).tolist())
            bias[i, np.isin(labels, list(allowed))] = 0.0
        return bias

    def _transform(self, df: DataFrame) -> DataFrame:
        self.require_columns(df, self.get("conditioner_col"))
        return super()._transform(df)
