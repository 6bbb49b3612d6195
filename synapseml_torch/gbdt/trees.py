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
  the NaN bin;
* categorical features split LightGBM's many-vs-many way: a node's bins
  sorted by ``g / (h + cat_smooth)`` (a stable sort, as ``jnp.argsort``),
  prefixes of that order are the candidate left sets, at most
  ``max_cat_threshold`` categories; the winning set is the node's
  ``cat_mask`` row, and a row routes left iff its category is a member.

Where the JAX package jits a level step and scans, this module runs the
same tensor program eagerly, a Python loop over levels, and updates its own
tree tensors in place. Every step stays on the tensors' device with no host
sync.

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
           "level_row_partition", "route_rows", "derive_max_depth", "max_nodes",
           "cat_route_left"]


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
    # categorical features (sorted feature indices; their bins ARE the raw
    # category codes), split many-vs-many (reference categoricalSlotIndexes)
    categorical_features: tuple = ()
    max_cat_threshold: int = 32
    cat_smooth: float = 10.0


class TreeArrays(NamedTuple):
    """One tree in heap layout; leaf nodes have ``feature == -1``."""

    feature: torch.Tensor  # (M,) int32, -1 = leaf
    threshold_bin: torch.Tensor  # (M,) int32, split: bin <= thr goes left
    leaf_value: torch.Tensor  # (M,) float32
    gain: torch.Tensor  # (M,) float32, split gain (0 at leaves) — feeds importance
    cover: torch.Tensor  # (M,) float32, rows reaching the node — feeds TreeSHAP
    # (M, B) uint8 left-membership per bin of categorical splits; (M, 1)
    # zeros when the config has no categorical features. A node is
    # categorical iff its row has any nonzero (a valid categorical split
    # always has a nonempty left set)
    cat_mask: torch.Tensor | None = None


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
    """Row→child routing ingredients for one level: which rows sit in a
    splitting node, their winning feature's bin, and the numeric left/right
    decision. Returns ``(rel, row_split, f_of_row, row_bin, go_left)``;
    callers may override ``go_left`` (categorical membership) before
    :func:`route_rows`."""
    here = (node_of_row >= base) & (node_of_row < base + width)
    rel = torch.where(here, node_of_row - base, 0).to(torch.int64)
    row_split = do_split[rel] & here
    f_of_row = best_feat[rel].to(torch.int64)
    row_bin = torch.gather(bins, 1, f_of_row[:, None])[:, 0].to(torch.int64)
    go_left = row_bin.to(torch.int32) <= best_thr[rel]
    return rel, row_split, f_of_row, row_bin, go_left


def route_rows(node_of_row, row_split, go_left):
    """Move each splitting row to its heap child (left = 2i+1)."""
    child = 2 * node_of_row + torch.where(go_left, 1, 2).to(torch.int32)
    return torch.where(row_split, child, node_of_row)


class _GrowState:
    """The tree tensors one growth updates in place, level by level."""

    def __init__(self, m: int, n: int, cat_width: int, device):
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
        self.cat_mask = torch.zeros((m, cat_width), dtype=torch.uint8, device=device)


class _CatTables(NamedTuple):
    """The categorical columns of a config, on the device."""

    idx: torch.Tensor      # (Fc,) int64 feature indices
    is_cat: torch.Tensor   # (F,) bool
    pos: torch.Tensor      # (F,) int64 position of each feature within idx


def _cat_tables(cfg: GrowthConfig, nf: int, device) -> _CatTables | None:
    if not cfg.categorical_features:
        return None
    idx = torch.tensor(cfg.categorical_features, dtype=torch.int64, device=device)
    is_cat = torch.zeros(nf, dtype=torch.bool, device=device)
    is_cat[idx] = True
    pos = torch.zeros(nf, dtype=torch.int64, device=device)
    pos[idx] = torch.arange(len(cfg.categorical_features), device=device)
    return _CatTables(idx, is_cat, pos)


def _categorical_prefixes(hist, gl, hl, cl, cat: _CatTables, cfg: GrowthConfig,
                          num_thresholds: int):
    """LightGBM's many-vs-many candidates: per node and categorical feature,
    bins sorted by ``g / (h + cat_smooth)`` (zero-count bins and the NaN
    bin, last, are never members, so unseen and missing categories route
    right); the prefix sums of that order overwrite the feature's left
    tables in place. Returns the order (W, Fc, B) and the prefixes' validity
    (W, Fc, num_thresholds): the prefix's last bin eligible, and at most
    ``max_cat_threshold`` categories."""
    B = hist.shape[2]
    hist_c = hist[:, cat.idx]  # (W, Fc, B, 3)
    gb, hb, cb = hist_c[..., 0], hist_c[..., 1], hist_c[..., 2]
    bins = torch.arange(B, device=hist.device)
    eligible = (cb > 0) & (bins != B - 1)[None, None, :]
    ratio = torch.where(eligible, gb / (hb + cfg.cat_smooth), torch.inf)
    order = torch.argsort(ratio, dim=2, stable=True)
    for left, chan in ((gl, gb), (hl, hb), (cl, cb)):
        sorted_chan = torch.gather(torch.where(eligible, chan, 0.0), 2, order)
        left[:, cat.idx] = torch.cumsum(sorted_chan, dim=2)[:, :, :num_thresholds]
    s_ok = torch.gather(eligible, 2, order)
    valid_k = s_ok[:, :, :num_thresholds] & (
        bins[:num_thresholds] < cfg.max_cat_threshold)[None, None, :]
    return order, valid_k


def _level_step(bins, grad, hess, presence, st: _GrowState, feat_mask, base: int,
                width: int, cfg: GrowthConfig, mono, fp, cat: _CatTables | None,
                rows=None) -> None:
    """One level: histogram → best splits → budget → tree + row partition."""
    num_thresholds = cfg.num_bins - 1  # the NaN bin is never a left-inclusive cut
    hist = level_histogram(bins, grad, hess, presence, st.node_of_row, base, width,
                           cfg.num_bins, impl=cfg.hist_impl, tree=fp, rows=rows)
    g_tot, h_tot, c_tot, gl, hl, cl = level_cum_tables(hist, num_thresholds)
    if cat is not None:
        gl, hl, cl = gl.clone(), hl.clone(), cl.clone()  # views of the cumsum
        cat_order, valid_k = _categorical_prefixes(hist, gl, hl, cl, cat, cfg,
                                                   num_thresholds)
    gr, hr, gain = split_gain(g_tot, h_tot, gl, hl, cfg)
    cr = c_tot[:, None, None] - cl
    ok = split_ok_mask(cl, cr, hl, hr, cfg) & feat_mask[None, :, None]
    if cat is not None:
        ok[:, cat.idx] = ok[:, cat.idx] & valid_k
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
    if cat is not None:
        # the winning left set: bins whose rank in the node's sorted order
        # falls inside the chosen prefix
        best_feat64 = best_feat.to(torch.int64)
        best_order = cat_order[torch.arange(width, device=bins.device),
                               cat.pos[best_feat64]]  # (W, B)
        inv_rank = torch.argsort(best_order, dim=-1)  # the inverse permutation
        is_cat_best = cat.is_cat[best_feat64]
        member = (inv_rank <= best_thr[:, None]) & (is_cat_best & do_split)[:, None]
        st.cat_mask[ids] = member.to(torch.uint8)

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

    rel, row_split, f_of_row, row_bin, go_left = level_row_partition(
        bins, st.node_of_row, do_split, best_feat, best_thr, base, width)
    if cat is not None:
        in_set = member.reshape(-1)[rel * cfg.num_bins + row_bin]
        go_left = torch.where(cat.is_cat[f_of_row], in_set, go_left)
    st.node_of_row = route_rows(st.node_of_row, row_split, go_left)


def _final_level(grad, hess, presence, st: _GrowState, base: int, width: int,
                 cfg: GrowthConfig, fp, rows=None) -> None:
    """At max depth every active node becomes a leaf (no histogram needed —
    just per-node g/h totals)."""
    tot = node_totals(grad, hess, presence, st.node_of_row, base, width, cfg.hist_impl, fp,
                      rows)
    active = tot[:, 2] > 0
    ids = slice(base, base + width)
    value = torch.clamp(_leaf_value(tot[:, 0], tot[:, 1], cfg), st.node_lo[ids], st.node_hi[ids])
    st.leaf_value[ids] = torch.where(active, value, 0.0)
    st.cover[ids] = tot[:, 2]


def grow_tree(bins, grad, hess, presence, cfg: GrowthConfig, feat_mask,
              rows=None) -> TreeArrays:
    """Grow one tree. ``bins`` (N, F) uint8 or int32; ``grad``/``hess`` (N,)
    float32 (sample weights already folded in); ``presence`` (N,) float32
    0/1 marks real vs padded rows (drives the count channel); ``feat_mask``
    (F,) bool. ``rows`` (a :class:`.hist.RowGroup`): these are this
    process's rows of a data-parallel fit; every histogram and node total is
    summed over the processes, so each grows the same tree."""
    cat_width = cfg.num_bins if cfg.categorical_features else 1
    st = _GrowState(max_nodes(cfg.max_depth), bins.shape[0], cat_width, bins.device)
    cat = _cat_tables(cfg, bins.shape[1], bins.device)
    mono = (torch.tensor(cfg.monotone_constraints, dtype=torch.int32, device=bins.device)
            if any(cfg.monotone_constraints) else None)
    # the kernel path's fixed-point scale and scratch, once a tree
    fp = (fixed_point_tree(grad, hess, presence, bins.shape[1], cfg.max_depth, cfg.num_bins,
                           rows)
          if cfg.hist_impl == "pallas" else None)
    for d in range(cfg.max_depth):
        _level_step(bins, grad, hess, presence, st, feat_mask, 2 ** d - 1, 2 ** d, cfg, mono,
                    fp, cat, rows)
    _final_level(grad, hess, presence, st, 2 ** cfg.max_depth - 1, 2 ** cfg.max_depth, cfg, fp,
                 rows)
    return TreeArrays(st.feature, st.threshold_bin, st.leaf_value, st.gain, st.cover,
                      st.cat_mask)


def traverse_binned(bins, tree: TreeArrays, max_depth: int):
    """Leaf values for binned rows (used to update train scores
    incrementally). A node routes categorically iff its cat_mask row is
    nonempty."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    cm = tree.cat_mask
    has_cat = cm is not None and cm.shape[1] > 1
    if has_cat:
        node_is_cat, cm_flat, nb = (cm > 0).any(dim=1), cm.reshape(-1), cm.shape[1]
    for _ in range(max_depth):
        f = tree.feature[node]
        b = torch.gather(bins, 1, torch.clamp(f, min=0)[:, None].to(torch.int64))[:, 0]
        go_left = b.to(torch.int32) <= tree.threshold_bin[node]
        if has_cat:
            in_set = cm_flat[node * nb + b.to(torch.int64)] > 0
            go_left = torch.where(node_is_cat[node], in_set, go_left)
        child = 2 * node + torch.where(go_left, 1, 2)
        node = torch.where(f < 0, node, child)
    return tree.leaf_value[node]


def cat_route_left(fv, go_left, node_is_cat, cat_masks, flat):
    """Overlay categorical routing on a numerical go-left decision: where
    ``node_is_cat``, a row goes left iff its raw value is a category code
    in ``[0, B)`` that its node's row of ``cat_masks`` (nodes, B) holds
    (``flat``: each row's node); NaN, out-of-range codes and non-members
    route right. The one routing rule of raw prediction, leaf indexing and
    the imported-model walk."""
    B = cat_masks.shape[-1]
    idx = torch.clamp(torch.nan_to_num(fv, nan=-1.0), -1, B).to(torch.int64).clamp(0, B - 1)
    in_set = (cat_masks.reshape(-1)[flat * B + idx] > 0) & (fv >= 0) & (fv < B)
    return torch.where(node_is_cat, in_set, go_left)


def leaf_index_forest(x, feature, threshold_value, max_depth: int, cat_masks=None):
    """Per-tree leaf index for each row, shape (N, T): every tree walked at
    once. ``feature``/``threshold_value`` (T, M); ``cat_masks`` optional
    (T, M, B) uint8 — for categorical nodes the raw value IS the category
    code and membership routes left. NaN features route right (comparisons
    with NaN are False), matching training's NaN-bin rule."""
    n, (t, m) = x.shape[0], feature.shape
    offset = torch.arange(t, device=x.device)[None, :] * m
    feat = feature.reshape(-1).to(torch.int64)
    thr = threshold_value.reshape(-1)
    if cat_masks is not None:
        cm = cat_masks.reshape(t * m, -1)
        node_is_cat = (cm > 0).any(dim=1)
    node = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        flat = node + offset
        f = feat[flat]
        fv = torch.gather(x, 1, torch.clamp(f, min=0))
        go_left = fv <= thr[flat]
        if cat_masks is not None:
            go_left = cat_route_left(fv, go_left, node_is_cat[flat], cm, flat)
        child = 2 * node + torch.where(go_left, 1, 2)
        node = torch.where(f < 0, node, child)
    return node


def predict_raw_forest(x, feature, threshold_value, leaf_value, max_depth: int,
                       cat_masks=None):
    """Raw-feature forest prediction: per-tree leaf sums (N,), the trees
    added in order as the JAX package's scan adds them. ``x`` (N, F)
    float32; ``feature``/``threshold_value``/``leaf_value`` (T, M);
    ``cat_masks`` optional (T, M, B) uint8."""
    node = leaf_index_forest(x, feature, threshold_value, max_depth, cat_masks)
    m = feature.shape[1]
    vals = leaf_value.reshape(-1)[node + torch.arange(feature.shape[0], device=x.device) * m]
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(vals.shape[1]):
        out = out + vals[:, t]
    return out
