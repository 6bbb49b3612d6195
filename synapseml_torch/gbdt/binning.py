"""Feature quantile binning — host-side prep for the on-device histogram trees.

Counterpart of ``BinMapper`` in ``synapseml_tpu/gbdt/binning.py`` (reference
LightGBM ``BinMapper``/``Dataset`` construction). Numpy only, with the
numpy per-column path of the JAX package's ``transform``; the JAX package
takes a native C++ path for float32 input, which it documents as bit-exact
with this one. Binned codes move to the device once and stay there for the
whole boosting run.

Missing values (NaN) get their own reserved bin (the last one), mirroring
LightGBM's ``use_missing`` default behavior.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BinMapper"]


class BinMapper:
    """Per-feature quantile bin boundaries fit on a sample of rows.

    ``max_bin`` counts real-value bins; one extra bin is reserved for NaN, so
    binned codes live in ``[0, max_bin]`` and the histogram width is
    ``max_bin + 1``.
    """

    def __init__(self, max_bin: int = 255, sample_count: int = 200_000, seed: int = 0):
        if not 2 <= max_bin <= 65535:
            raise ValueError(f"max_bin must be in [2, 65535], got {max_bin}")
        self.max_bin = int(max_bin)
        self.sample_count = int(sample_count)
        self.seed = int(seed)
        self.boundaries_: np.ndarray | None = None  # (F, max_bin - 1) float64

    @property
    def num_bins(self) -> int:
        return self.max_bin + 1  # + NaN bin

    @property
    def nan_bin(self) -> int:
        return self.max_bin

    def fit(self, features: np.ndarray) -> "BinMapper":
        x = np.asarray(features, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"features must be 2-D, got shape {x.shape}")
        n, f = x.shape
        if n > self.sample_count:
            rng = np.random.default_rng(self.seed)
            x = x[rng.choice(n, self.sample_count, replace=False)]
        qs = np.linspace(0.0, 1.0, self.max_bin + 1)[1:-1]
        bounds = np.empty((f, self.max_bin - 1), dtype=np.float64)
        for j in range(f):
            col = x[:, j]
            col = col[~np.isnan(col)]
            if col.size == 0:
                bounds[j] = 0.0
                continue
            # unique-aware boundaries: few distinct values -> one bin per value,
            # like LightGBM's FindBinWithZeroAsOneBin for low-cardinality features
            uniq = np.unique(col)
            if uniq.size <= self.max_bin:
                mids = (uniq[:-1] + uniq[1:]) / 2.0
                pad = np.full(self.max_bin - 1 - mids.size, np.inf)
                bounds[j] = np.concatenate([mids, pad])
            else:
                bounds[j] = np.quantile(col, qs, method="linear")
        self.boundaries_ = bounds
        return self

    def transform(self, features: np.ndarray) -> np.ndarray:
        """Rows → bin codes, shape (N, F): uint8 when ``num_bins <= 256``,
        else int32. Comparisons run in float64 (lossless for float32 input)."""
        if self.boundaries_ is None:
            raise RuntimeError("BinMapper not fitted")
        x = np.asarray(features, dtype=np.float64)  # no-op view for f64 input
        n, f = x.shape
        if f != self.boundaries_.shape[0]:
            raise ValueError(f"feature count {f} != fitted {self.boundaries_.shape[0]}")
        out = np.empty((n, f), dtype=np.int32)
        for j in range(f):
            out[:, j] = np.searchsorted(self.boundaries_[j], x[:, j], side="right")
        nan_mask = np.isnan(x)
        if nan_mask.any():
            out[nan_mask] = self.nan_bin
        if self.num_bins <= 256:
            return out.astype(np.uint8)
        return out

    def fit_transform(self, features: np.ndarray) -> np.ndarray:
        return self.fit(features).transform(features)

    def upper_bound_values(self) -> np.ndarray:
        """(F, num_bins) real-valued upper edge per bin — lets a trained booster
        predict from raw floats without the mapper (thresholds stored as values,
        the same trick LightGBM model files use)."""
        if self.boundaries_ is None:
            raise RuntimeError("BinMapper not fitted")
        f = self.boundaries_.shape[0]
        ub = np.full((f, self.num_bins), np.inf)
        ub[:, : self.max_bin - 1] = self.boundaries_
        return ub

    def to_dict(self) -> dict:
        return {
            "max_bin": self.max_bin,
            "sample_count": self.sample_count,
            "seed": self.seed,
            "boundaries": None if self.boundaries_ is None else self.boundaries_.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        if d.get("categorical"):
            raise NotImplementedError("categorical binning is not ported yet")
        m = cls(d["max_bin"], d["sample_count"], d["seed"])
        if d.get("boundaries") is not None:
            m.boundaries_ = np.asarray(d["boundaries"], dtype=np.float64)
        return m
