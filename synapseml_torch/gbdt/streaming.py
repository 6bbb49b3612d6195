"""Out-of-core GBDT: histograms built from a streamed source in
fixed-memory passes.

Counterpart of ``synapseml_tpu/gbdt/streaming.py``. The in-memory path
(``booster.train_booster``) keeps the full binned matrix on the device;
this module trains when it does not fit: features stream shard by shard
from a :class:`synapseml_torch.data.ShardedSource` and are never
materialized whole. Host memory is bounded by O(shard) for features; the
per-row vectors every out-of-core GBDT keeps (labels, scores, gradients,
node assignment: n×1, not n×F) live on the device.

Pass structure (the LightGBM out-of-core discipline):

1. **stats pass**: stream shards once, count rows, collect labels, and
   reservoir-sample rows for quantile bin-boundary fitting
   (``BinMapper.fit`` on the sample: fixed memory whatever n).
2. **bin+spill pass**: stream shards again, bin each shard and spill the
   bin codes (uint16) to local ``.npy`` files; iterations then stream the
   spill (mmap) instead of re-reading and re-binning the source.
3. **training**: per boosting iteration, per tree level, stream spilled
   chunks, route each row from its previous-level node, and add the
   chunk's ``(nodes, features, bins, 3)`` level histogram on the device
   through :func:`.hist.level_histogram` with the default ``'segment'``
   backend, as the JAX streamed path takes its default backend. Split
   decisions run on the summed histogram with the gain and leaf-value
   math of :mod:`.trees`, so streamed and in-memory training agree up to
   float-summation order.

Supported surface: gbdt boosting, numerical features, the scalar and
multiclass objectives. Bagging/GOSS/DART, categorical splits and monotone
constraints stay on the in-memory path.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Sequence

import numpy as np
import torch

from ..core.instrumentation import InstrumentationMeasures
from . import objectives as obj
from . import trees as T
from .binning import BinMapper
from .booster import Booster, resolve_device
from .hist import level_histogram

__all__ = ["train_booster_streamed"]

_CHUNK_ROWS = 16384


class _Spill:
    """The local binned cache: one .npy per source shard + row offsets."""

    def __init__(self, directory: str, files: list[str], counts: list[int]):
        self.directory = directory
        self.files = files
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.num_features = np.load(files[0], mmap_mode="r").shape[1]

    @property
    def n(self) -> int:
        return int(self.offsets[-1])

    def chunks(self, chunk_rows: int):
        """Yield (global_start, int32 bins chunk) in fixed-memory slices."""
        for f, off in zip(self.files, self.offsets[:-1]):
            mm = np.load(f, mmap_mode="r")
            for lo in range(0, mm.shape[0], chunk_rows):
                hi = min(lo + chunk_rows, mm.shape[0])
                yield int(off + lo), np.asarray(mm[lo:hi]).astype(np.int32)

    def close(self):
        shutil.rmtree(self.directory, ignore_errors=True)


def _feature_matrix(cols: dict, feature_cols: Sequence[str]) -> np.ndarray:
    missing = [c for c in feature_cols if c not in cols]
    if missing:
        raise ValueError(f"shard is missing feature column(s) {missing} "
                         f"(expected {list(feature_cols)}); streamed "
                         "training needs a uniform schema across shards")
    mats = []
    for c in feature_cols:
        v = np.asarray(cols[c])
        mats.append(v[:, None] if v.ndim == 1 else v.reshape(v.shape[0], -1))
    return np.concatenate(mats, axis=1).astype(np.float32, copy=False)


def _grow_tree_streamed(spill: _Spill, g, h, node_of, cfg: T.GrowthConfig, chunk_rows: int):
    """One tree in heap layout from streamed binned chunks. ``g``/``h``
    (n,) float32 and ``node_of`` (n,) int32 on the device; on return
    ``node_of`` holds each row's final resting node, so the caller updates
    scores without another pass."""
    dev = g.device
    max_depth, B = cfg.max_depth, cfg.num_bins
    M = T.max_nodes(max_depth)
    feature = torch.full((M,), -1, dtype=torch.int32, device=dev)
    threshold_bin = torch.zeros(M, dtype=torch.int32, device=dev)
    leaf_value = torch.zeros(M, dtype=torch.float32, device=dev)
    node_gain = torch.zeros(M, dtype=torch.float32, device=dev)
    node_cover = torch.zeros(M, dtype=torch.float32, device=dev)
    leaf_count = torch.ones((), dtype=torch.int32, device=dev)
    node_of.zero_()
    nf = spill.num_features

    def route_chunk(bins_c, lo, hi, base, width):
        """Move the chunk's rows out of split nodes of level [base, base+width)."""
        nc = node_of[lo:hi]
        here = (nc >= base) & (nc < base + width)
        node_ids = torch.where(here, nc, base).to(torch.int64)
        f_of = torch.clamp(feature[node_ids], min=0).to(torch.int64)
        row_bin = torch.gather(bins_c, 1, f_of[:, None])[:, 0]
        go_left = row_bin <= threshold_bin[node_ids]
        split = here & (feature[node_ids] >= 0)
        node_of[lo:hi] = torch.where(split, 2 * nc + torch.where(go_left, 1, 2).to(torch.int32),
                                     nc)

    num_thresholds = B - 1  # the NaN bin is never a left-inclusive cut
    for depth in range(max_depth):
        base, width = 2 ** depth - 1, 2 ** depth
        hist = torch.zeros((width, nf, B, 3), dtype=torch.float32, device=dev)
        for lo, bins_np in spill.chunks(chunk_rows):
            hi = lo + bins_np.shape[0]
            bins_c = torch.from_numpy(bins_np).to(dev)
            if depth > 0:
                route_chunk(bins_c, lo, hi, 2 ** (depth - 1) - 1, 2 ** (depth - 1))
            presence = torch.ones(hi - lo, dtype=torch.float32, device=dev)
            hist += level_histogram(bins_c, g[lo:hi], h[lo:hi], presence, node_of[lo:hi],
                                    base, width, B)

        # -- split decision on the summed histogram (trees.py math) ---------
        g_tot, h_tot, c_tot, gl, hl, cl = T.level_cum_tables(hist, num_thresholds)
        gr, hr, gain = T.split_gain(g_tot, h_tot, gl, hl, cfg)
        ok = T.split_ok_mask(cl, c_tot[:, None, None] - cl, hl, hr, cfg)
        gain = torch.where(ok, gain, -torch.inf)
        _, best_gain, best_feat, best_thr, active, do_split = T.select_level_splits(
            gain, c_tot, leaf_count, cfg, width, num_thresholds)
        ids = slice(base, base + width)
        feature[ids] = torch.where(do_split, best_feat, -1)
        threshold_bin[ids] = torch.where(do_split, best_thr, 0)
        value = T._leaf_value(g_tot, h_tot, cfg)
        leaf_value[ids] = torch.where(active & ~do_split, value, 0.0)
        node_gain[ids] = torch.where(do_split, best_gain, 0.0)
        node_cover[ids] = c_tot
        leaf_count = leaf_count + do_split.sum(dtype=torch.int32)

    # final routing pass (into level max_depth) + leaf totals in float64
    if max_depth > 0:
        for lo, bins_np in spill.chunks(chunk_rows):
            route_chunk(torch.from_numpy(bins_np).to(dev), lo, lo + bins_np.shape[0],
                        2 ** (max_depth - 1) - 1, 2 ** (max_depth - 1))
    fbase, fwidth = 2 ** max_depth - 1, 2 ** max_depth
    at_final = node_of >= fbase
    rel = (node_of[at_final] - fbase).to(torch.int64)

    def total(v):
        return torch.zeros(fwidth, dtype=torch.float64, device=dev).index_add_(
            0, rel, v[at_final].to(torch.float64))

    gt, ht = total(g), total(h)
    ct = torch.bincount(rel, minlength=fwidth).to(torch.float32)
    ids = slice(fbase, fbase + fwidth)
    vals = T._leaf_value(gt.to(torch.float32), ht.to(torch.float32), cfg)
    leaf_value[ids] = torch.where(ct > 0, vals, 0.0)
    node_cover[ids] = ct
    return feature, threshold_bin, leaf_value, node_gain, node_cover


def train_booster_streamed(source, *, label_col: str = "label",
                           feature_cols: Sequence[str] | None = None,
                           objective: str = "regression", num_class: int = 1,
                           num_iterations: int = 50,
                           learning_rate: float = 0.1, num_leaves: int = 31,
                           max_depth: int = 6, max_bin: int = 255,
                           lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                           min_data_in_leaf: int = 20,
                           min_sum_hessian: float = 1e-3,
                           min_gain_to_split: float = 0.0, seed: int = 0,
                           sample_rows: int = 200_000,
                           spill_dir: str | None = None,
                           chunk_rows: int = _CHUNK_ROWS,
                           measures=None, device="cuda") -> Booster:
    """Train a :class:`~.booster.Booster` from a streamed source on
    ``device`` (default ``"cuda"``; see the module docstring for the pass
    structure and the supported surface)."""
    if objective == "lambdarank":
        raise ValueError("lambdarank needs group structure and stays on the "
                         "in-memory path (train_booster)")
    dev = resolve_device(device)
    if measures is None:
        measures = InstrumentationMeasures()
    if max_depth is None or int(max_depth) <= 0:
        # the in-memory engine's convention: <=0 derives a heap-layout bound
        # deep enough for num_leaves
        max_depth = max(int(np.ceil(np.log2(max(num_leaves, 2)))) + 1, 3)
    max_depth = min(int(max_depth), 10)

    # -- pass 1: row count, labels, reservoir sample ------------------------
    rng = np.random.default_rng(seed)
    reservoir: np.ndarray | None = None
    labels: list[np.ndarray] = []
    counts: list[int] = []
    seen = 0
    inferred_cols = feature_cols is None
    with measures.measure("stats_pass"):
        for shard, cols in source.iter_shards():
            if not cols:
                # degenerate byte-range shard (no complete line): both passes
                # agree it holds zero rows, so spill files stay aligned with
                # the recorded counts
                counts.append(0)
                continue
            if label_col not in cols:
                raise ValueError(
                    f"shard {shard.target} has no label column "
                    f"{label_col!r} (columns: {sorted(cols)}); pass "
                    "label_col= for this dataset")
            if feature_cols is None:
                feature_cols = sorted(k for k in cols if k != label_col)
            elif inferred_cols:
                # inferred from shard 0: a LATER shard introducing extra keys
                # would otherwise be silently excluded from the model
                extra = sorted(k for k in cols if k != label_col and k not in feature_cols)
                if extra:
                    raise ValueError(
                        f"shard {shard.target} carries column(s) {extra} "
                        f"absent from the first shard (inferred features "
                        f"{list(feature_cols)}); schema drifts across "
                        "shards — pass feature_cols= explicitly")
            feats = _feature_matrix(cols, feature_cols)
            labels.append(np.asarray(cols[label_col], np.float32))
            counts.append(feats.shape[0])
            if reservoir is None:
                reservoir = np.empty((0, feats.shape[1]), np.float32)
            room = sample_rows - reservoir.shape[0]
            if room > 0:
                reservoir = np.concatenate([reservoir, feats[:room]])
                feats = feats[room:]
            if feats.shape[0]:
                # Algorithm R (vectorized): row with global index i draws
                # j ~ U[0, i]; j < capacity replaces slot j
                pos = sample_rows + seen + np.arange(feats.shape[0])
                draw = rng.integers(0, pos + 1)
                take = draw < sample_rows
                reservoir[draw[take]] = feats[take]
                seen += feats.shape[0]
    y = np.concatenate(labels) if labels else np.empty(0, np.float32)
    n = y.shape[0]
    if n == 0:
        raise ValueError("streamed training needs at least one row")

    # -- pass 2: fit bins on the sample, spill binned shards ----------------
    mapper = BinMapper(max_bin=max_bin, seed=seed)
    with measures.measure("binning"):
        mapper.fit(reservoir)
        directory = spill_dir or tempfile.mkdtemp(prefix="synapseml_gbdt_")
        os.makedirs(directory, exist_ok=True)
        files = []
        n_features = reservoir.shape[1]
        for i, (shard, cols) in enumerate(source.iter_shards()):
            feats = (_feature_matrix(cols, feature_cols) if cols
                     else np.empty((0, n_features), np.float32))
            path = os.path.join(directory, f"binned_{i:05d}.npy")
            np.save(path, mapper.transform(feats, device=dev).astype(np.uint16))
            files.append(path)
    spill = _Spill(directory, files, counts)

    # -- training -----------------------------------------------------------
    o = obj.get_objective(objective, num_class=num_class)
    K = o.num_model_out
    yd = torch.from_numpy(y).to(dev)
    init = o.init_score(yd).reshape(K).to(torch.float32)
    scores = init[None, :].repeat(n, 1)
    node_of = torch.zeros(n, dtype=torch.int32, device=dev)
    cfg = T.GrowthConfig(max_depth=max_depth, num_leaves=num_leaves,
                         num_bins=mapper.num_bins, lambda_l1=lambda_l1,
                         lambda_l2=lambda_l2, learning_rate=learning_rate,
                         min_data_in_leaf=min_data_in_leaf,
                         min_sum_hessian=min_sum_hessian,
                         min_gain_to_split=min_gain_to_split)
    forest = []
    try:
        with measures.measure("training"):
            for _ in range(num_iterations):
                measures.count("iterations")
                g, h = o.grad_hess(scores, yd)
                g, h = g.reshape(n, -1), h.reshape(n, -1)
                per_class = []
                for k in range(K):
                    tree = _grow_tree_streamed(spill, g[:, k].contiguous(),
                                               h[:, k].contiguous(), node_of, cfg, chunk_rows)
                    scores[:, k] += tree[2][node_of.to(torch.int64)]
                    per_class.append(tree)
                forest.append(per_class)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if spill_dir is None:
            spill.close()

    acc_f, acc_t, acc_v, acc_g, acc_c = (
        torch.stack([torch.stack([t[i] for t in per_class]) for per_class in forest])
        .cpu().numpy() for i in range(5))
    ub = mapper.upper_bound_values()
    thr_val = np.where(acc_f >= 0, ub[np.maximum(acc_f, 0), acc_t], 0.0).astype(np.float32)
    booster = Booster(
        acc_f, thr_val, acc_v, acc_g, cover=acc_c, max_depth=max_depth,
        num_model_out=K, objective=o.name, init_score=init.cpu().numpy(),
        num_features=int(reservoir.shape[1]), device=str(dev),
        params={"num_iterations": num_iterations,
                "learning_rate": learning_rate, "num_leaves": num_leaves,
                "max_bin": max_bin, "streamed": True})
    booster.bin_mapper = mapper
    booster.train_measures = measures.to_dict()
    return booster
