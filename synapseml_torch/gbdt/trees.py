"""Level-wise histogram tree growth on torch tensors.

Counterpart of ``synapseml_tpu/gbdt/trees.py`` (reference: the native hot
loop behind ``LGBM_BoosterUpdateOneIter``: histogram construction,
best-split search and row partition). The same design:

* trees live in fixed-size heap-layout arrays (node ``i`` -> children
  ``2i+1``/``2i+2``);
* growth is level-wise: one histogram pass per depth builds the histograms
  of all active nodes of the level at once (:func:`.hist.level_histogram`);
  LightGBM's ``num_leaves`` cap is honoured by ranking candidate splits by
  gain at each level and splitting only as many as the leaf budget allows;
* missing values (NaN bin = last bin) route right; thresholds never cover
  the NaN bin.

Where the JAX package jits a level step and scans, this module runs the
same tensor program eagerly, a Python loop over levels, and updates its own
tree tensors in place. Every step stays on the tensors' device with no host
sync. Categorical splits are not ported yet (``booster.train_booster``
refuses them).

Histogram channels: (grad, hess, count).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hist import fixed_point_tree, level_histogram, node_totals

__all__ = ["GrowthConfig", "TreeArrays", "grow_tree", "traverse_binned",
           "predict_raw_forest", "leaf_index_forest", "level_cum_tables",
           "split_gain", "split_ok_mask", "select_level_splits",
           "level_row_partition", "route_rows", "derive_max_depth", "max_nodes"]


class GrowthConfig(NamedTuple):
    """Static growth hyper-parameters."""

    max_depth: int
    num_leaves: int
    num_bins: int
    lambda_l1: float
    lambda_l2: float
    learning_rate: float
    min_data_in_leaf: int
    min_sum_hessian: float
    min_gain_to_split: float
    # per-feature monotone constraints (+1/-1/0), () = unconstrained
    # (reference monotoneConstraints; the 'basic' method: split-direction
    # gating + child-value midpoint bounds)
    monotone_constraints: tuple = ()
    # histogram backend: 'segment' | 'onehot' | 'pallas' (the CUDA kernel,
    # .hist.fixed_point_histogram)
    hist_impl: str = "segment"


class TreeArrays(NamedTuple):
    """One tree in heap layout; leaf nodes have ``feature == -1``."""

    feature: torch.Tensor  # (M,) int32, -1 = leaf
    threshold_bin: torch.Tensor  # (M,) int32, split: bin <= thr goes left
    leaf_value: torch.Tensor  # (M,) float32
    gain: torch.Tensor  # (M,) float32, split gain (0 at leaves) — feeds importance
    cover: torch.Tensor  # (M,) float32, rows reaching the node — feeds TreeSHAP


def max_nodes(max_depth: int) -> int:
    return 2 ** (max_depth + 1) - 1


def _soft_threshold(g, l1: float):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _leaf_value(g, h, cfg):
    return -_soft_threshold(g, cfg.lambda_l1) / (h + cfg.lambda_l2 + 1e-12) * cfg.learning_rate


def _split_score(g, h, cfg):
    gs = _soft_threshold(g, cfg.lambda_l1)
    return gs * gs / (h + cfg.lambda_l2 + 1e-12)


def derive_max_depth(max_depth: int, num_leaves: int) -> int:
    """Effective tree depth: deep enough for ``num_leaves``, heap-bounded at
    12 (the JAX package's one formula)."""
    if max_depth is None or max_depth <= 0:
        max_depth = max(int(np.ceil(np.log2(max(num_leaves, 2)))) + 1, 3)
    return min(max_depth, 12)


def level_cum_tables(hist, num_thresholds: int):
    """Node totals + cumulative left-prefix channels from one level's
    histograms: ``(g_tot, h_tot, c_tot, gl, hl, cl)`` with ``*_tot`` shaped
    (W,) and the left tables (W, F, num_thresholds). The scan runs along a
    non-innermost axis of a 4-D tensor, which torch sums in a fixed order on
    the card as on the CPU."""
    cum = torch.cumsum(hist, dim=2)  # (W, F, B, 3)
    total = cum[:, 0, -1, :]  # (W, 3) — feature 0's full sum == node totals
    left = cum[:, :, :num_thresholds, :]  # (W, F, B-1, 3)
    return (total[:, 0], total[:, 1], total[:, 2],
            left[..., 0], left[..., 1], left[..., 2])


def split_gain(g_tot, h_tot, gl, hl, cfg):
    """Candidate split gains (W, F, num_thresholds) plus the right-side
    grad/hess tables. ``cfg`` only needs ``lambda_l1``/``lambda_l2``."""
    gr = g_tot[:, None, None] - gl
    hr = h_tot[:, None, None] - hl
    gain = (_split_score(gl, hl, cfg) + _split_score(gr, hr, cfg)
            - _split_score(g_tot, h_tot, cfg)[:, None, None])
    return gr, hr, gain


def split_ok_mask(cl, cr, hl, hr, cfg):
    """Data-count / hessian-mass split validity (W, F, num_thresholds)."""
    return ((cl >= cfg.min_data_in_leaf) & (cr >= cfg.min_data_in_leaf)
            & (hl >= cfg.min_sum_hessian) & (hr >= cfg.min_sum_hessian))


def select_level_splits(gain, c_tot, leaf_count, cfg, width: int, num_thresholds: int):
    """Best split per node + the level's leaf-budget decision: argmax over
    (feature, threshold) — the first maximum wins, as ``jnp.argmax`` — the
    min_gain gate, and top-(remaining-budget) ranking by gain, ties broken
    by position (a stable sort, as ``jnp.argsort``). Returns
    ``(best_idx, best_gain, best_feat, best_thr, active, do_split)``."""
    flat = gain.reshape(width, -1)
    best_idx = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_feat = torch.div(best_idx, num_thresholds, rounding_mode="floor").to(torch.int32)
    best_thr = (best_idx % num_thresholds).to(torch.int32)
    # a node is "active" at this level iff it actually holds rows
    active = c_tot > 0
    can_split = active & (best_gain > cfg.min_gain_to_split)
    # leaf budget: each split nets +1 leaf; split the top-(budget) gains
    budget = torch.clamp(cfg.num_leaves - leaf_count, min=0)
    order = torch.argsort(torch.where(can_split, -best_gain, torch.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(width, device=gain.device)
    do_split = can_split & (rank < budget)
    return best_idx, best_gain, best_feat, best_thr, active, do_split


def level_row_partition(bins, node_of_row, do_split, best_feat, best_thr,
                        base: int, width: int):
    """Row→child routing for one level: which rows sit in a splitting node,
    and whether their winning feature's bin sends them left. Returns
    ``(row_split, go_left)``."""
    here = (node_of_row >= base) & (node_of_row < base + width)
    rel = torch.where(here, node_of_row - base, 0).to(torch.int64)
    row_split = do_split[rel] & here
    row_bin = torch.gather(bins, 1, best_feat[rel][:, None].to(torch.int64))[:, 0]
    go_left = row_bin.to(torch.int32) <= best_thr[rel]
    return row_split, go_left


def route_rows(node_of_row, row_split, go_left):
    """Move each splitting row to its heap child (left = 2i+1)."""
    child = 2 * node_of_row + torch.where(go_left, 1, 2).to(torch.int32)
    return torch.where(row_split, child, node_of_row)


class _GrowState:
    """The tree tensors one growth updates in place, level by level."""

    def __init__(self, m: int, n: int, device):
        i32, f32 = dict(dtype=torch.int32, device=device), dict(dtype=torch.float32, device=device)
        self.feature = torch.full((m,), -1, **i32)
        self.threshold_bin = torch.zeros(m, **i32)
        self.leaf_value = torch.zeros(m, **f32)
        self.gain = torch.zeros(m, **f32)
        self.cover = torch.zeros(m, **f32)
        self.node_lo = torch.full((m,), -torch.inf, **f32)
        self.node_hi = torch.full((m,), torch.inf, **f32)
        self.node_of_row = torch.zeros(n, **i32)
        self.leaf_count = torch.ones((), **i32)


def _level_step(bins, grad, hess, presence, st: _GrowState, feat_mask, base: int,
                width: int, cfg: GrowthConfig, mono, fp) -> None:
    """One level: histogram → best splits → budget → tree + row partition."""
    num_thresholds = cfg.num_bins - 1  # the NaN bin is never a left-inclusive cut
    hist = level_histogram(bins, grad, hess, presence, st.node_of_row, base, width,
                           cfg.num_bins, impl=cfg.hist_impl, tree=fp)
    g_tot, h_tot, c_tot, gl, hl, cl = level_cum_tables(hist, num_thresholds)
    gr, hr, gain = split_gain(g_tot, h_tot, gl, hl, cfg)
    cr = c_tot[:, None, None] - cl
    ok = split_ok_mask(cl, cr, hl, hr, cfg) & feat_mask[None, :, None]
    if mono is not None:
        # monotone gating: a split on a constrained feature is only valid if
        # the would-be child values respect the direction
        vl = _leaf_value(gl, hl, cfg)
        vr = _leaf_value(gr, hr, cfg)
        c = mono[None, :, None]
        ok &= torch.where(c > 0, vl <= vr, torch.where(c < 0, vl >= vr, True))
    gain = torch.where(ok, gain, -torch.inf)

    best_idx, best_gain, best_feat, best_thr, active, do_split = select_level_splits(
        gain, c_tot, st.leaf_count, cfg, width, num_thresholds)

    ids = slice(base, base + width)
    st.feature[ids] = torch.where(do_split, best_feat, -1)
    st.threshold_bin[ids] = torch.where(do_split, best_thr, 0)
    lo, hi = st.node_lo[ids], st.node_hi[ids]
    # active nodes that do not split become final leaves now (clamped to the
    # monotone bounds inherited from ancestors)
    value = torch.clamp(_leaf_value(g_tot, h_tot, cfg), lo, hi)
    st.leaf_value[ids] = torch.where(active & ~do_split, value, 0.0)
    st.gain[ids] = torch.where(do_split, best_gain, 0.0)
    st.cover[ids] = c_tot
    st.leaf_count = st.leaf_count + do_split.sum(dtype=torch.int32)

    # propagate monotone bounds to children: on a +1 split the left subtree is
    # capped at the midpoint and the right floored (basic method);
    # unconstrained splits inherit the parent bounds. Heap children of the
    # level's nodes are the next level's nodes, left and right interleaved.
    if mono is not None:
        def best_of(v):
            return torch.gather(v.reshape(width, -1), 1, best_idx[:, None])[:, 0]

        bvl = best_of(_leaf_value(gl, hl, cfg))
        bvr = best_of(_leaf_value(gr, hr, cfg))
        mid = torch.clamp((bvl + bvr) * 0.5, lo, hi)
        cf = mono[best_feat.to(torch.int64)]
        l_hi = torch.where(do_split & (cf > 0), torch.minimum(hi, mid), hi)
        r_lo = torch.where(do_split & (cf > 0), torch.maximum(lo, mid), lo)
        l_lo = torch.where(do_split & (cf < 0), torch.maximum(lo, mid), lo)
        r_hi = torch.where(do_split & (cf < 0), torch.minimum(hi, mid), hi)
    else:
        l_lo, l_hi, r_lo, r_hi = lo, hi, lo, hi
    kids = slice(2 * base + 1, 2 * base + 1 + 2 * width)
    st.node_lo[kids] = torch.stack([l_lo, r_lo], dim=1).reshape(-1)
    st.node_hi[kids] = torch.stack([l_hi, r_hi], dim=1).reshape(-1)

    row_split, go_left = level_row_partition(bins, st.node_of_row, do_split, best_feat,
                                             best_thr, base, width)
    st.node_of_row = route_rows(st.node_of_row, row_split, go_left)


def _final_level(grad, hess, presence, st: _GrowState, base: int, width: int,
                 cfg: GrowthConfig, fp) -> None:
    """At max depth every active node becomes a leaf (no histogram needed —
    just per-node g/h totals)."""
    tot = node_totals(grad, hess, presence, st.node_of_row, base, width, cfg.hist_impl, fp)
    active = tot[:, 2] > 0
    ids = slice(base, base + width)
    value = torch.clamp(_leaf_value(tot[:, 0], tot[:, 1], cfg), st.node_lo[ids], st.node_hi[ids])
    st.leaf_value[ids] = torch.where(active, value, 0.0)
    st.cover[ids] = tot[:, 2]


def grow_tree(bins, grad, hess, presence, cfg: GrowthConfig, feat_mask) -> TreeArrays:
    """Grow one tree. ``bins`` (N, F) uint8 or int32; ``grad``/``hess`` (N,)
    float32 (sample weights already folded in); ``presence`` (N,) float32
    0/1 marks real vs padded rows (drives the count channel); ``feat_mask``
    (F,) bool."""
    st = _GrowState(max_nodes(cfg.max_depth), bins.shape[0], bins.device)
    mono = (torch.tensor(cfg.monotone_constraints, dtype=torch.int32, device=bins.device)
            if any(cfg.monotone_constraints) else None)
    # the kernel path's fixed-point scale and scratch, once a tree
    fp = (fixed_point_tree(grad, hess, presence, bins.shape[1], cfg.max_depth, cfg.num_bins)
          if cfg.hist_impl == "pallas" else None)
    for d in range(cfg.max_depth):
        _level_step(bins, grad, hess, presence, st, feat_mask, 2 ** d - 1, 2 ** d, cfg, mono, fp)
    _final_level(grad, hess, presence, st, 2 ** cfg.max_depth - 1, 2 ** cfg.max_depth, cfg, fp)
    return TreeArrays(st.feature, st.threshold_bin, st.leaf_value, st.gain, st.cover)


def traverse_binned(bins, tree: TreeArrays, max_depth: int):
    """Leaf values for binned rows (used to update train scores incrementally)."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f = tree.feature[node]
        b = torch.gather(bins, 1, torch.clamp(f, min=0)[:, None].to(torch.int64))[:, 0]
        go_left = b.to(torch.int32) <= tree.threshold_bin[node]
        child = 2 * node + torch.where(go_left, 1, 2)
        node = torch.where(f < 0, node, child)
    return tree.leaf_value[node]


def leaf_index_forest(x, feature, threshold_value, max_depth: int):
    """Per-tree leaf index for each row, shape (N, T): every tree walked at
    once. ``feature``/``threshold_value`` (T, M). NaN features route right
    (comparisons with NaN are False), matching training's NaN-bin rule."""
    n, (t, m) = x.shape[0], feature.shape
    offset = torch.arange(t, device=x.device)[None, :] * m
    feat = feature.reshape(-1).to(torch.int64)
    thr = threshold_value.reshape(-1)
    node = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        flat = node + offset
        f = feat[flat]
        fv = torch.gather(x, 1, torch.clamp(f, min=0))
        child = 2 * node + torch.where(fv <= thr[flat], 1, 2)
        node = torch.where(f < 0, node, child)
    return node


def predict_raw_forest(x, feature, threshold_value, leaf_value, max_depth: int):
    """Raw-feature forest prediction: per-tree leaf sums (N,), the trees
    added in order as the JAX package's scan adds them. ``x`` (N, F)
    float32; ``feature``/``threshold_value``/``leaf_value`` (T, M)."""
    node = leaf_index_forest(x, feature, threshold_value, max_depth)
    m = feature.shape[1]
    vals = leaf_value.reshape(-1)[node + torch.arange(feature.shape[0], device=x.device) * m]
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(vals.shape[1]):
        out = out + vals[:, t]
    return out
