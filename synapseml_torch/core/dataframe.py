"""Partitioned columnar DataFrame — the data plane of the framework.

Counterpart of ``synapseml_tpu/core/dataframe.py``, copied as it is: an
eager, partitioned, columnar table whose columns are numpy arrays. It is
numpy only, so it needs nothing of the accelerator stack; strings and
objects stay host-side for the tokenizers.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

__all__ = ["DataFrame", "Partition", "schema_of", "concat_partitions", "scalar_of"]

Partition = dict  # name -> np.ndarray, all the same length


def scalar_of(v: Any) -> Any:
    """Unwrap numpy scalars to python scalars (stable dict keys / comparisons)."""
    return v.item() if isinstance(v, np.generic) else v


def _as_column(values: Any, n: int | None = None) -> np.ndarray:
    """Coerce python values to a column array, keeping ragged/object data as dtype=object."""
    if isinstance(values, np.ndarray):
        return values
    if np.isscalar(values) or values is None:
        if n is None:
            raise ValueError("scalar column requires a length")
        arr = np.empty(n, dtype=object) if isinstance(values, (str, bytes, type(None))) else None
        if arr is not None:
            arr[:] = values
            return arr
        return np.full(n, values)
    values = list(values)
    if values and isinstance(values[0], (str, bytes, dict, list, tuple, np.ndarray, type(None))):
        # ragged / nested: keep as object column so downstream code can tokenize etc.
        if values and isinstance(values[0], (list, tuple, np.ndarray)):
            try:
                arr = np.asarray(values)
                if arr.dtype != object and arr.ndim >= 2:
                    return arr  # rectangular numeric nested column -> real ndarray
            except (ValueError, TypeError):
                pass
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr
    return np.asarray(values)


def _column_len(arr: np.ndarray) -> int:
    return arr.shape[0]


def schema_of(part: Partition) -> dict:
    """Lightweight schema: name -> (dtype string, per-row shape)."""
    out = {}
    for name, arr in part.items():
        shape = tuple(arr.shape[1:]) if isinstance(arr, np.ndarray) else ()
        dtype = str(arr.dtype) if isinstance(arr, np.ndarray) else type(arr).__name__
        out[name] = (dtype, shape)
    return out


def concat_partitions(parts: Sequence[Partition]) -> Partition:
    if not parts:
        return {}
    keys = list(parts[0].keys())
    out = {}
    for k in keys:
        cols = [p[k] for p in parts]
        if any(c.dtype == object for c in cols):
            merged = np.empty(sum(len(c) for c in cols), dtype=object)
            i = 0
            for c in cols:
                if c.dtype == object:
                    merged[i : i + len(c)] = c
                else:
                    # rectangular partition merging into a ragged column:
                    # assign row-by-row so numpy doesn't try to broadcast
                    for j in range(len(c)):
                        merged[i + j] = c[j]
                i += len(c)
            out[k] = merged
        else:
            out[k] = np.concatenate(cols, axis=0)
    return out


class DataFrame:
    """An eager, partitioned columnar table.

    Mirrors the portion of the Spark DataFrame API the reference's stages rely
    on (select/withColumn/mapPartitions/repartition/randomSplit/union/cache),
    cf. reference ``core/.../stages/`` and ``LightGBMBase.prepareDataframe``
    (``lightgbm/.../LightGBMBase.scala:109-144``).
    """

    def __init__(self, partitions: Sequence[Partition]):
        parts = [dict(p) for p in partitions if p]
        if not parts:
            parts = [{}]
        cols = list(parts[0].keys())
        for p in parts:
            if list(p.keys()) != cols:
                raise ValueError(f"inconsistent partition schemas: {list(p.keys())} vs {cols}")
        self._parts: list[Partition] = parts

    # ---------------- constructors ----------------
    @staticmethod
    def from_dict(data: Mapping[str, Any], num_partitions: int = 1) -> "DataFrame":
        cols = {}
        n = None
        for k, v in data.items():
            arr = _as_column(v, n)
            n = _column_len(arr) if n is None else n
            if _column_len(arr) != n:
                raise ValueError(f"column {k} length {_column_len(arr)} != {n}")
            cols[k] = arr
        df = DataFrame([cols])
        return df.repartition(num_partitions) if num_partitions > 1 else df

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]], num_partitions: int = 1) -> "DataFrame":
        if not rows:
            return DataFrame([{}])
        keys = list(rows[0].keys())
        data = {k: [r[k] for r in rows] for k in keys}
        return DataFrame.from_dict(data, num_partitions)

    @staticmethod
    def from_pandas(pdf, num_partitions: int = 1) -> "DataFrame":
        data = {c: pdf[c].to_numpy() for c in pdf.columns}
        return DataFrame.from_dict(data, num_partitions)

    # ---------------- introspection ----------------
    @property
    def columns(self) -> list[str]:
        return list(self._parts[0].keys())

    @property
    def schema(self) -> dict:
        return schema_of(self._parts[0])

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    @property
    def partitions(self) -> list[Partition]:
        return self._parts

    def count(self) -> int:
        return sum(_column_len(next(iter(p.values()))) if p else 0 for p in self._parts)

    def is_empty(self) -> bool:
        return self.count() == 0

    def __repr__(self) -> str:
        return f"DataFrame(rows={self.count()}, partitions={self.num_partitions}, schema={self.schema})"

    # ---------------- column ops ----------------
    def select(self, *cols: str) -> "DataFrame":
        names = list(cols[0]) if len(cols) == 1 and isinstance(cols[0], (list, tuple)) else list(cols)
        missing = [c for c in names if c not in self.columns]
        if missing:
            raise KeyError(f"columns not found: {missing}; have {self.columns}")
        return DataFrame([{c: p[c] for c in names} for p in self._parts])

    def drop(self, *cols: str) -> "DataFrame":
        names = set(cols[0]) if len(cols) == 1 and isinstance(cols[0], (list, tuple)) else set(cols)
        keep = [c for c in self.columns if c not in names]
        return self.select(keep)

    def with_column(self, name: str, fn_or_values: Any) -> "DataFrame":
        """Add/replace a column. ``fn_or_values`` is either a per-partition
        callable ``Partition -> array`` or a full-length array/list."""
        new_parts = []
        if callable(fn_or_values):
            for p in self._parts:
                col = _as_column(fn_or_values(p), _column_len(next(iter(p.values()))) if p else 0)
                q = dict(p)
                q[name] = col
                new_parts.append(q)
        else:
            arr = _as_column(fn_or_values, self.count())
            if _column_len(arr) != self.count():
                raise ValueError(f"column length {_column_len(arr)} != row count {self.count()}")
            i = 0
            for p in self._parts:
                n = _column_len(next(iter(p.values()))) if p else 0
                q = dict(p)
                q[name] = arr[i : i + n]
                i += n
                new_parts.append(q)
        return DataFrame(new_parts)

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame([{(new if k == old else k): v for k, v in p.items()} for p in self._parts])

    def with_columns(self, mapping: Mapping[str, Any]) -> "DataFrame":
        df = self
        for k, v in mapping.items():
            df = df.with_column(k, v)
        return df

    def __getitem__(self, name: str) -> np.ndarray:
        return self.collect_column(name)

    # ---------------- row ops ----------------
    def filter(self, fn: Callable[[Partition], np.ndarray]) -> "DataFrame":
        """fn: Partition -> boolean mask array."""
        out = []
        for p in self._parts:
            mask = np.asarray(fn(p), dtype=bool)
            out.append({k: v[mask] for k, v in p.items()})
        return DataFrame([p for p in out if p and _column_len(next(iter(p.values()))) > 0] or out[:1])

    def limit(self, n: int) -> "DataFrame":
        taken, out = 0, []
        for p in self._parts:
            if taken >= n:
                break
            cnt = _column_len(next(iter(p.values()))) if p else 0
            take = min(cnt, n - taken)
            out.append({k: v[:take] for k, v in p.items()})
            taken += take
        return DataFrame(out or [self._parts[0]])

    def map_partitions(self, fn: Callable[[Partition], Partition]) -> "DataFrame":
        """The workhorse — reference analog: ``df.rdd.mapPartitions`` used by every
        engine adapter (e.g. ``ONNXModel.scala:242``, ``HTTPTransformer.scala:122``)."""
        return DataFrame([fn(p) for p in self._parts])

    def map_rows(self, fn: Callable[[dict], dict]) -> "DataFrame":
        def per_part(p: Partition) -> Partition:
            n = _column_len(next(iter(p.values()))) if p else 0
            rows = [fn({k: v[i] for k, v in p.items()}) for i in range(n)]
            if not rows:
                return p
            return {k: _as_column([r[k] for r in rows]) for k in rows[0]}

        return self.map_partitions(per_part)

    # ---------------- partitioning ----------------
    def repartition(self, n: int) -> "DataFrame":
        if n <= 0:
            raise ValueError("num partitions must be positive")
        whole = concat_partitions(self._parts)
        total = _column_len(next(iter(whole.values()))) if whole else 0
        bounds = [round(i * total / n) for i in range(n + 1)]
        parts = [{k: v[bounds[i] : bounds[i + 1]] for k, v in whole.items()} for i in range(n)]
        return DataFrame(parts)

    def coalesce(self, n: int) -> "DataFrame":
        if n >= self.num_partitions:
            return self
        groups: list[list[Partition]] = [[] for _ in range(n)]
        per = math.ceil(self.num_partitions / n)
        for i, p in enumerate(self._parts):
            groups[min(i // per, n - 1)].append(p)
        return DataFrame([concat_partitions(g) for g in groups if g])

    # ---------------- combination ----------------
    def union(self, other: "DataFrame") -> "DataFrame":
        if self.columns != other.columns:
            raise ValueError(f"union schema mismatch: {self.columns} vs {other.columns}")
        return DataFrame(self._parts + other._parts)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> list["DataFrame"]:
        whole = concat_partitions(self._parts)
        n = _column_len(next(iter(whole.values()))) if whole else 0
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        w = np.asarray(weights, dtype=float)
        w = w / w.sum()
        bounds = np.concatenate([[0], np.round(np.cumsum(w) * n).astype(int)])
        out = []
        for i in range(len(weights)):
            idx = np.sort(perm[bounds[i] : bounds[i + 1]])
            out.append(DataFrame([{k: v[idx] for k, v in whole.items()}]))
        return out

    def sample(self, fraction: float, seed: int = 0, with_replacement: bool = False) -> "DataFrame":
        rng = np.random.default_rng(seed)
        out = []
        for p in self._parts:
            n = _column_len(next(iter(p.values()))) if p else 0
            if with_replacement:
                idx = rng.integers(0, max(n, 1), size=int(round(n * fraction)))
            else:
                idx = np.nonzero(rng.random(n) < fraction)[0]
            out.append({k: v[idx] for k, v in p.items()})
        return DataFrame(out)

    def sort(self, col: str, ascending: bool = True) -> "DataFrame":
        whole = concat_partitions(self._parts)
        order = np.argsort(whole[col], kind="stable")
        if not ascending:
            order = order[::-1]
        return DataFrame([{k: v[order] for k, v in whole.items()}])

    def cache(self) -> "DataFrame":
        return self  # eager: everything already materialized

    def group_by(self, *keys: str) -> "GroupedDataFrame":
        """Group rows by key column(s); aggregate with ``.agg(...)``.

        Host-side (collect + pandas groupby): the reference delegates this to
        Spark's shuffle; here grouping is metadata-scale work — the device plane
        carries the numeric compute, not the relational shuffle.
        """
        missing = [k for k in keys if k not in self.columns]
        if missing:
            raise KeyError(f"group_by keys {missing} not in {self.columns}")
        return GroupedDataFrame(self, keys)

    def join(self, other: "DataFrame", on: str | Sequence[str],
             how: str = "inner") -> "DataFrame":
        """Relational join on key column(s) (host-side pandas merge;
        ``how``: inner | left | right | outer). Result is single-partition —
        repartition() for parallel downstream stages."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"how must be inner|left|right|outer, got {how!r}")
        keys = [on] if isinstance(on, str) else list(on)
        for k in keys:
            if k not in self.columns:
                raise KeyError(f"join key {k!r} not in left columns {self.columns}")
            if k not in other.columns:
                raise KeyError(f"join key {k!r} not in right columns {other.columns}")
        merged = self.to_pandas().merge(other.to_pandas(), on=keys, how=how)
        return DataFrame.from_pandas(merged)

    # ---------------- materialization ----------------
    def collect(self) -> Partition:
        return concat_partitions(self._parts)

    def collect_column(self, name: str) -> np.ndarray:
        if name not in self.columns:
            raise KeyError(f"no column {name}; have {self.columns}")
        return concat_partitions([{name: p[name]} for p in self._parts])[name]

    def collect_rows(self) -> list[dict]:
        whole = self.collect()
        n = _column_len(next(iter(whole.values()))) if whole else 0
        return [{k: v[i] for k, v in whole.items()} for i in range(n)]

    def first(self) -> dict:
        rows = self.limit(1).collect_rows()
        if not rows:
            raise ValueError("empty DataFrame")
        return rows[0]

    def to_pandas(self):
        import pandas as pd

        whole = self.collect()
        flat = {}
        for k, v in whole.items():
            flat[k] = list(v) if v.ndim > 1 else v
        return pd.DataFrame(flat)


class GroupedDataFrame:
    """Result of :meth:`DataFrame.group_by`; terminal ``agg``/``count``."""

    _AGGS = ("sum", "mean", "min", "max", "count", "first", "std", "nunique")

    def __init__(self, df: DataFrame, keys):
        self._df = df
        self._keys = list(keys)

    def agg(self, spec: Mapping[str, str]) -> DataFrame:
        """``{column: aggregation}`` -> one row per group. Aggregations:
        sum | mean | min | max | count | first | std | nunique. Output
        columns are named ``{col}_{agg}`` (Spark's default naming)."""
        bad = {c: a for c, a in spec.items() if a not in self._AGGS}
        if bad:
            raise ValueError(f"unsupported aggregations {bad}; "
                             f"choose from {self._AGGS}")
        missing = [c for c in spec if c not in self._df.columns]
        if missing:
            raise KeyError(f"agg columns {missing} not in {self._df.columns}")
        pdf = self._df.to_pandas()
        out = pdf.groupby(self._keys, sort=True).agg(
            **{f"{c}_{a}": (c, a) for c, a in spec.items()}).reset_index()
        return DataFrame.from_pandas(out)

    def count(self) -> DataFrame:
        """Rows per group as a ``count`` column."""
        pdf = self._df.to_pandas()
        out = pdf.groupby(self._keys, sort=True).size().rename("count").reset_index()
        return DataFrame.from_pandas(out)
