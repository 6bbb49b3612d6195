"""Feature quantile binning — host-side prep for the on-device histogram trees.

Counterpart of ``BinMapper`` in ``synapseml_tpu/gbdt/binning.py`` (reference
LightGBM ``BinMapper``/``Dataset`` construction). Numpy, with the numpy
per-column path of the JAX package's ``transform``; the JAX package takes a
native C++ path for float32 input, which it documents as bit-exact with this
one. ``transform(..., device=<cuda>)`` runs the same float64 comparisons on
the card (``torch.searchsorted``, numpy's ``side="right"``), bit-exact with
the host path. Binned codes move to the device once and stay there for the
whole boosting run.

Missing values (NaN) get their own reserved bin (the last one), mirroring
LightGBM's ``use_missing`` default behavior. Categorical features bin by
identity: the category code is the bin, and codes outside ``[0, max_bin)``
or NaN go to the NaN bin (LightGBM's unseen-category rule: they route
right).
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

    def __init__(self, max_bin: int = 255, sample_count: int = 200_000, seed: int = 0,
                 categorical: tuple = ()):
        if not 2 <= max_bin <= 65535:
            raise ValueError(f"max_bin must be in [2, 65535], got {max_bin}")
        self.max_bin = int(max_bin)
        self.sample_count = int(sample_count)
        self.seed = int(seed)
        self.categorical = tuple(int(i) for i in categorical)
        self.boundaries_: np.ndarray | None = None  # (F, max_bin - 1) float64

    @property
    def num_bins(self) -> int:
        return self.max_bin + 1  # + NaN bin

    @property
    def nan_bin(self) -> int:
        return self.max_bin

    def fit(self, features: np.ndarray) -> "BinMapper":
        x = np.asarray(features)
        if x.ndim != 2:
            raise ValueError(f"features must be 2-D, got shape {x.shape}")
        n, f = x.shape
        if n > self.sample_count:
            rng = np.random.default_rng(self.seed)
            x = x[rng.choice(n, self.sample_count, replace=False)]
        x = np.asarray(x, dtype=np.float64)  # the sample only
        qs = np.linspace(0.0, 1.0, self.max_bin + 1)[1:-1]
        bounds = np.empty((f, self.max_bin - 1), dtype=np.float64)
        for j in range(f):
            col = x[:, j]
            # sorted once: np.unique's values, and np.quantile's order statistics
            col = np.sort(col[~np.isnan(col)])
            if col.size == 0:
                bounds[j] = 0.0
                continue
            # unique-aware boundaries: few distinct values -> one bin per value,
            # like LightGBM's FindBinWithZeroAsOneBin for low-cardinality features
            uniq = col[np.concatenate(([True], col[1:] != col[:-1]))]
            if uniq.size <= self.max_bin:
                mids = (uniq[:-1] + uniq[1:]) / 2.0
                pad = np.full(self.max_bin - 1 - mids.size, np.inf)
                bounds[j] = np.concatenate([mids, pad])
            else:
                bounds[j] = np.quantile(col, qs, method="linear")
        self.boundaries_ = bounds
        return self

    def transform(self, features: np.ndarray, device=None) -> np.ndarray:
        """Rows → bin codes, shape (N, F): uint8 when ``num_bins <= 256``,
        else int32. Comparisons run in float64 (lossless for float32 input):
        on the host, or on ``device`` when it is a CUDA device."""
        if self.boundaries_ is None:
            raise RuntimeError("BinMapper not fitted")
        x = np.asarray(features)
        if x.ndim != 2:
            raise ValueError(f"features must be 2-D, got shape {x.shape}")
        n, f = x.shape
        if f != self.boundaries_.shape[0]:
            raise ValueError(f"feature count {f} != fitted {self.boundaries_.shape[0]}")
        if self.categorical and not all(0 <= i < f for i in self.categorical):
            raise ValueError(f"categorical indices {sorted(self.categorical)} "
                             f"out of range [0, {f})")
        if device is not None and str(device).startswith("cuda"):
            return self._transform_torch(x, device)
        x = np.asarray(x, dtype=np.float64)  # no-op view for f64 input
        out = np.empty((n, f), dtype=np.int32)
        cat = set(self.categorical)
        for j in range(f):
            if j in cat:
                col = x[:, j]
                code = np.floor(col)
                valid = np.isfinite(col) & (code >= 0) & (code < self.max_bin)
                out[:, j] = np.where(valid, code, self.nan_bin).astype(np.int32)
            else:
                out[:, j] = np.searchsorted(self.boundaries_[j], x[:, j], side="right")
        nan_mask = np.isnan(x)
        if nan_mask.any():
            out[nan_mask] = self.nan_bin  # a no-op on categorical columns
        if self.num_bins <= 256:
            return out.astype(np.uint8)
        return out

    def _transform_torch(self, x: np.ndarray, device, block: int = 1 << 26) -> np.ndarray:
        """``transform``'s comparisons as torch ops on ``device`` (any device:
        the tests hold it to the host path on the CPU), in column blocks of
        about ``block`` elements."""
        import torch

        n, f = x.shape
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        bounds = torch.from_numpy(self.boundaries_).to(device)
        codes = torch.empty((f, n), dtype=torch.int32, device=device)
        cat = set(self.categorical)
        step = max(1, block // max(n, 1))
        for j0 in range(0, f, step):
            j1 = min(f, j0 + step)
            cols = xd[:, j0:j1].T.to(torch.float64).contiguous()  # (k, N)
            out = torch.searchsorted(bounds[j0:j1].contiguous(), cols, right=True,
                                     out_int32=True)
            for j in cat & set(range(j0, j1)):
                col = cols[j - j0]
                code = torch.floor(col)
                valid = torch.isfinite(col) & (code >= 0) & (code < self.max_bin)
                out[j - j0] = torch.where(valid, code, float(self.nan_bin)).to(torch.int32)
            out[torch.isnan(cols)] = self.nan_bin  # a no-op on categorical columns
            codes[j0:j1] = out
        dtype = torch.uint8 if self.num_bins <= 256 else torch.int32
        result = codes.T.to(dtype).contiguous().cpu().numpy()
        # boundaries made NaN by infinite values: numpy's search order there
        # is its own, so those columns take the host path
        for j in np.flatnonzero(np.isnan(self.boundaries_).any(axis=1)):
            if j not in cat:
                col = np.asarray(x[:, j], dtype=np.float64)
                code = np.searchsorted(self.boundaries_[j], col, side="right")
                code[np.isnan(col)] = self.nan_bin
                result[:, j] = code
        return result

    def fit_transform(self, features: np.ndarray, device=None) -> np.ndarray:
        return self.fit(features).transform(features, device=device)

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
            "categorical": list(self.categorical),
            "boundaries": None if self.boundaries_ is None else self.boundaries_.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls(d["max_bin"], d["sample_count"], d["seed"],
                categorical=tuple(d.get("categorical", ())))
        if d.get("boundaries") is not None:
            m.boundaries_ = np.asarray(d["boundaries"], dtype=np.float64)
        return m
