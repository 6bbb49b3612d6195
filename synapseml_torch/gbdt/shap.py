"""TreeSHAP — exact per-feature contributions for the heap-layout forests.

Counterpart of ``synapseml_tpu/gbdt/shap.py``, copied as it is (numpy only).
Reference: ``booster/LightGBMBooster.scala:418`` ``featuresShap`` (LightGBM's
``predict_contrib``). This is the polynomial-time Tree SHAP algorithm
(Lundberg et al.) over our fixed-shape heap trees, vectorized over rows with
numpy: path one-fractions and permutation weights are (N,) arrays, so one
recursion over the tree covers the whole row batch. Output layout matches
LightGBM: per model-output ``F`` feature columns plus a bias column (expected
value), and ``sum(contrib, -1) == raw_score`` exactly (additivity).
"""

from __future__ import annotations

import numpy as np

__all__ = ["forest_shap"]


class _Path:
    """One SHAP path: parallel lists of feature idx, zero/one fractions and
    permutation weights; ``o``/``w`` entries are per-row (N,) arrays."""

    __slots__ = ("f", "z", "o", "w")

    def __init__(self, f, z, o, w):
        self.f, self.z, self.o, self.w = f, z, o, w

    def copy(self):
        return _Path(list(self.f), list(self.z), [x.copy() for x in self.o],
                     [x.copy() for x in self.w])


def _extend(m: _Path, pz: float, po: np.ndarray, pi: int) -> None:
    l = len(m.f)
    m.f.append(pi)
    m.z.append(pz)
    m.o.append(po)
    m.w.append(np.ones_like(po) if l == 0 else np.zeros_like(po))
    for i in range(l - 1, -1, -1):
        m.w[i + 1] = m.w[i + 1] + po * m.w[i] * ((i + 1) / (l + 1))
        m.w[i] = pz * m.w[i] * ((l - i) / (l + 1))


def _unwound_sum(m: _Path, i: int) -> np.ndarray:
    """Sum of path weights with element i unwound (without mutating m)."""
    l = len(m.f) - 1
    o, z = m.o[i], m.z[i]
    total = np.zeros_like(m.w[0])
    n = m.w[l].copy()
    o_nonzero = o != 0
    safe_o = np.where(o_nonzero, o, 1.0)
    for j in range(l - 1, -1, -1):
        # where o != 0: invert the extend step; where o == 0: closed form
        t = np.where(o_nonzero,
                     n * (l + 1) / ((j + 1) * safe_o),
                     m.w[j] * (l + 1) / (max(l - j, 1) * z) if z != 0
                     else np.zeros_like(n))
        total = total + t
        n = np.where(o_nonzero, m.w[j] - t * z * ((l - j) / (l + 1)), n)
    return total


def _unwind(m: _Path, i: int) -> _Path:
    """Remove path element i (the inverse of _extend at position i)."""
    l = len(m.f) - 1
    o, z = m.o[i], m.z[i]
    out = m.copy()
    n = out.w[l].copy()
    o_nonzero = o != 0
    safe_o = np.where(o_nonzero, o, 1.0)
    for j in range(l - 1, -1, -1):
        if z != 0:
            t_zero = out.w[j] * (l + 1) / (max(l - j, 1) * z)
        else:
            t_zero = np.zeros_like(n)
        t = np.where(o_nonzero, n * (l + 1) / ((j + 1) * safe_o), t_zero)
        n = np.where(o_nonzero, out.w[j] - t * z * ((l - j) / (l + 1)), n)
        out.w[j] = t
    out.f.pop(i)
    out.z.pop(i)
    out.o.pop(i)
    out.w.pop()  # weights were recomputed in place for the shortened path
    return out


def _tree_shap(feature, threshold, value, cover, X, phi, cat_mask=None):
    """Accumulate one tree's contributions into phi (N, F+1); ``cat_mask``
    (M, B) uint8 routes categorical nodes by left-set membership."""
    N = X.shape[0]

    def recurse(node: int, m: _Path, pz: float, po: np.ndarray, pi: int):
        m = m.copy()
        # duplicate feature on the path: unwind the previous occurrence and
        # fold its fractions into the incoming ones
        if pi >= 0:
            for k in range(1, len(m.f)):
                if m.f[k] == pi:
                    pz = pz * m.z[k]
                    po = po * m.o[k]
                    m = _unwind(m, k)
                    break
        _extend(m, pz, po, pi)
        f = int(feature[node])
        if f < 0:  # leaf
            v = float(value[node])
            if v != 0.0:
                for i in range(1, len(m.f)):
                    w = _unwound_sum(m, i)
                    phi[:, m.f[i]] += w * (m.o[i] - m.z[i]) * v
            return
        left, right = 2 * node + 1, 2 * node + 2
        if cat_mask is not None and cat_mask[node].any():
            B = cat_mask.shape[1]
            col = X[:, f]
            code = np.floor(col)
            valid = np.isfinite(col) & (code >= 0) & (code < B)
            idx = np.where(valid, code, 0).astype(np.int64)
            go_left = (valid & (cat_mask[node][idx] > 0)).astype(np.float64)
        else:
            go_left = (X[:, f] <= threshold[node]).astype(np.float64)
        c = max(float(cover[node]), 1e-12)
        zl = float(cover[left]) / c
        zr = float(cover[right]) / c
        recurse(left, m, zl, go_left, f)
        recurse(right, m, zr, 1.0 - go_left, f)

    ones = np.ones(N, np.float64)
    recurse(0, _Path([], [], [], []), 1.0, ones, -1)

    # bias column: E[tree] = cover-weighted leaf average
    leaves = feature < 0
    w = np.where(leaves, cover, 0.0)
    total = w.sum()
    if total > 0:
        phi[:, -1] += float((w * value).sum() / total)


def forest_shap(feature: np.ndarray, threshold_value: np.ndarray,
                leaf_value: np.ndarray, cover: np.ndarray,
                init_score: np.ndarray, X: np.ndarray,
                cat_mask: np.ndarray | None = None) -> np.ndarray:
    """(N, K, F+1) SHAP contributions for a stacked forest.

    feature/threshold_value/leaf_value/cover: (T, K, M); init_score: (K,).
    Column F (last) is the expected value (bias), and for every row
    ``contrib.sum(-1) == raw_score`` (checked by tests).
    """
    X = np.asarray(X, np.float64)
    T, K, M = feature.shape
    N, F = X.shape
    out = np.zeros((N, K, F + 1), np.float64)
    for k in range(K):
        phi = out[:, k, :]
        phi[:, -1] += float(init_score[k])
        for t in range(T):
            _tree_shap(feature[t, k], threshold_value[t, k], leaf_value[t, k],
                       cover[t, k], X, phi,
                       cat_mask=None if cat_mask is None else cat_mask[t, k])
    return out
