"""Booster — boosting orchestration, prediction, persistence.

Counterpart of ``synapseml_tpu/gbdt/booster.py`` (``TpuBooster``,
``train_booster``; reference ``booster/LightGBMBooster.scala`` and the
training loop of ``TrainUtils.scala``). Training keeps the binned matrix
(uint8 when the bins fit, where the JAX package widens to int32), the
labels, weights and running scores on the device for the whole run, and
grows every tree there; the forest comes back to the host in one transfer
at the end. The JAX package's two training programs — one scan over all
iterations, and a host loop when early stopping or dart needs a decision
per iteration — are one Python loop here (dart its own loop).

Every mode of the JAX booster is here: ``boosting_type`` gbdt, goss (the
top ``top_rate`` rows by |grad|·weight plus ``other_rate`` of the rest,
amplified), dart (tree dropout, 1/(k+1) normalisation; its drops come from
``np.random.default_rng(seed + 17)`` as in the JAX package, so dart without
sampling grows the JAX forest) and rf (bagged trees on the initial scores,
averaged output); row bagging resampled every ``bagging_freq`` iterations;
``feature_fraction`` as the ``k_feat`` lowest random ranks; categorical
features; lambdarank over ``group_sizes``; continued training from a
booster or a LightGBM model string (``init_model``). Torch cannot
reproduce ``jax.random``'s bits, so the bagging, feature and goss draws
come from numpy generators seeded by (seed, purpose, iteration) on the
host, one stream a purpose as the JAX keys are folded, and are copied to
the device: a fit is the same on the card and on the CPU for one seed, and
held to the JAX package by distribution. The fused sweep waits for
ROADMAP.md queue A item 11.

``mesh`` (a :class:`~synapseml_torch.parallel.MeshContext`) splits the rows
over its ``data`` axis, the JAX package's row sharding: every process holds
the same inputs, bins them, draws the samples and computes the initial
score on all rows, then keeps its own rows (padded to a multiple of the
axis size with presence and weight 0; lambdarank splits at query-group
boundaries instead, so that every group stays on one process) and grows
the trees from histograms summed over the processes (:class:`.hist.RowGroup`).
With ``histogram_impl='pallas'`` the forest is the one-process forest bit
for bit; goss's threshold sorts the gradients gathered from every process.

A :class:`Booster` holds host numpy arrays, so it pickles with no device in
it; device copies of its trees are cached per (device, iterations) and
dropped on pickling. Its on-disk format (``trees.npz`` + ``booster.json``)
is the JAX ``TpuBooster``'s: either package loads what the other saved.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import device as core_device
from ..core.device import device_type
from ..core.instrumentation import InstrumentationMeasures
from . import objectives as obj
from . import trees as T
from .binning import BinMapper
from .hist import HIST_IMPLS, RowGroup

__all__ = ["Booster", "TpuBooster", "train_booster", "train_booster_from_source",
           "fold_positive_class_weight", "resolve_device", "device_type"]

_PREDICT_ROW_CHUNK = 1 << 17  # rows per forest walk: bounds the (rows, trees) index tensors


def resolve_device(spec) -> torch.device:
    """``torch.device(spec)``, refusing ``cuda`` on a host without a card."""
    if device_type(spec) not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', got {spec!r}")
    return core_device.resolve_device("Booster", spec)


def train_booster_from_source(source, **kwargs) -> "Booster":
    """Out-of-core training: histograms built from a streamed
    :class:`synapseml_torch.data.ShardedSource` in fixed-memory passes (see
    :mod:`.streaming` for the pass structure and the parameter surface)."""
    from .streaming import train_booster_streamed

    return train_booster_streamed(source, **kwargs)


class Booster:
    """A trained forest. Arrays are host numpy, stacked (iterations, K, M)."""

    def __init__(self, feature: np.ndarray, threshold_value: np.ndarray,
                 leaf_value: np.ndarray, gain: np.ndarray, *, max_depth: int,
                 num_model_out: int, objective: str, init_score: np.ndarray,
                 num_features: int, params: dict | None = None,
                 best_iteration: int | None = None,
                 cover: np.ndarray | None = None,
                 average_output: bool = False,
                 cat_mask: np.ndarray | None = None,
                 categorical_features: tuple = (), device="cuda"):
        self.feature = feature
        self.threshold_value = threshold_value
        self.leaf_value = leaf_value
        self.gain = gain
        self.cover = cover
        self.max_depth = int(max_depth)
        self.num_model_out = int(num_model_out)
        self.objective = objective
        self.init_score = np.asarray(init_score, dtype=np.float32)
        self.num_features = int(num_features)
        self.params = dict(params or {})
        self.best_iteration = best_iteration
        self.average_output = bool(average_output)  # rf mode: mean over trees
        # (T, K, M, B) uint8 left-membership of categorical splits, or None
        self.cat_mask = cat_mask
        self.categorical_features = tuple(categorical_features or ())
        self.device = str(device)  # where predictions run unless a call says otherwise
        self._device_cache: dict = {}

    @property
    def num_iterations(self) -> int:
        return self.feature.shape[0]

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_device_cache"] = {}  # device tensors stay out of pickles
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device_cache = {}

    # ---------------- prediction ----------------
    def _n_iters(self, num_iterations: int | None) -> int:
        n_it = num_iterations or self.best_iteration or self.num_iterations
        return min(n_it, self.num_iterations)

    def _trees_on(self, device: torch.device, n_it: int):
        """(K*T, M)-shaped feature/threshold/leaf tensors of the first
        ``n_it`` iterations, class-major (tree t of class k at row k*T + t),
        and the (K*T, M, B) categorical masks or None, cached on ``device``."""
        key = (str(device), n_it)
        if key not in self._device_cache:
            def stacked(a):
                a = np.ascontiguousarray(np.swapaxes(a[:n_it], 0, 1))  # (K, T, M, ...)
                return torch.from_numpy(a.reshape(-1, *a.shape[2:])).to(device)

            self._device_cache[key] = (
                stacked(self.feature), stacked(self.threshold_value),
                stacked(self.leaf_value),
                None if self.cat_mask is None else stacked(self.cat_mask))
        return self._device_cache[key]

    def _raw(self, x: torch.Tensor, n_it: int) -> torch.Tensor:
        feat, thr, val, cm = self._trees_on(x.device, n_it)
        K = self.num_model_out

        def cls(a, k):
            return None if a is None else a[k * n_it:(k + 1) * n_it]

        outs = [T.predict_raw_forest(x, cls(feat, k), cls(thr, k), cls(val, k), self.max_depth,
                                     cat_masks=cls(cm, k))
                for k in range(K)]
        avg = 1.0 / n_it if self.average_output else 1.0
        init = torch.from_numpy(self.init_score).to(x.device)
        return torch.stack(outs, dim=1) * avg + init[None, :]

    def raw_score_and_predict(self, features: np.ndarray, num_iterations: int | None = None,
                              device=None) -> tuple[np.ndarray, np.ndarray]:
        """``(raw margins (N, K), objective-transformed predictions)`` from
        one forest walk on ``device`` (default: the booster's)."""
        dev = resolve_device(device or self.device)
        n_it = self._n_iters(num_iterations)
        o = obj.get_objective(self.objective, num_class=self.num_model_out)
        x_all = np.asarray(features, dtype=np.float32)
        raws, preds = [], []
        with torch.inference_mode():
            for s in range(0, max(x_all.shape[0], 1), _PREDICT_ROW_CHUNK):
                x = torch.from_numpy(np.ascontiguousarray(x_all[s:s + _PREDICT_ROW_CHUNK])).to(dev)
                raw = self._raw(x, n_it)
                raws.append(raw.cpu().numpy())
                preds.append(o.transform(raw).cpu().numpy())
        return np.concatenate(raws), np.concatenate(preds)

    def raw_score(self, features: np.ndarray, num_iterations: int | None = None,
                  device=None) -> np.ndarray:
        """(N, K) raw margin scores."""
        return self.raw_score_and_predict(features, num_iterations, device)[0]

    def predict(self, features: np.ndarray, num_iterations: int | None = None,
                device=None) -> np.ndarray:
        """Objective-transformed predictions: probabilities for binary
        (N,), softmax (N, K) for multiclass, raw values for regression."""
        return self.raw_score_and_predict(features, num_iterations, device)[1]

    def predict_contrib(self, features: np.ndarray) -> np.ndarray:
        """(N, K, F+1) exact TreeSHAP contributions + bias column, on the host
        (reference ``LightGBMBooster.featuresShap``). Additivity:
        ``contrib.sum(-1) == raw_score``."""
        if self.cover is None:
            raise ValueError("this booster has no per-node cover statistics "
                             "(trained before TreeSHAP support); retrain to "
                             "enable predict_contrib")
        from .shap import forest_shap

        n_it = self.best_iteration or self.num_iterations
        contrib = forest_shap(self.feature[:n_it], self.threshold_value[:n_it],
                              self.leaf_value[:n_it], self.cover[:n_it],
                              np.zeros_like(self.init_score),
                              np.asarray(features, np.float64),
                              cat_mask=None if self.cat_mask is None
                              else self.cat_mask[:n_it])
        if self.average_output:  # rf: raw = init + mean(trees)
            contrib = contrib / n_it
        contrib[:, :, -1] += np.asarray(self.init_score, np.float64)
        return contrib

    def predict_leaf(self, features: np.ndarray, num_iterations: int | None = None,
                     device=None) -> np.ndarray:
        """(N, T*K) per-tree leaf node index (reference ``predictLeaf``),
        iteration-major as the JAX package orders it."""
        dev = resolve_device(device or self.device)
        n_it = self._n_iters(num_iterations)
        t, k, m = self.feature[:n_it].shape
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)).to(dev)
            feat = torch.from_numpy(self.feature[:n_it].reshape(t * k, m)).to(dev)
            thr = torch.from_numpy(self.threshold_value[:n_it].reshape(t * k, m)).to(dev)
            cm = (None if self.cat_mask is None else
                  torch.from_numpy(self.cat_mask[:n_it].reshape(t * k, m, -1)).to(dev))
            return T.leaf_index_forest(x, feat, thr, self.max_depth,
                                       cat_masks=cm).to(torch.int32).cpu().numpy()

    # ---------------- introspection ----------------
    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Per-feature importance: 'split' counts or total 'gain'
        (reference ``LightGBMBooster.getFeatureImportances``)."""
        flat_feat = self.feature.reshape(-1)
        out = np.zeros(self.num_features, dtype=np.float64)
        valid = flat_feat >= 0
        if importance_type == "split":
            np.add.at(out, flat_feat[valid], 1.0)
        elif importance_type == "gain":
            np.add.at(out, flat_feat[valid], self.gain.reshape(-1)[valid])
        else:
            raise ValueError(f"importance_type must be 'split' or 'gain', got {importance_type}")
        return out

    # ---------------- persistence ----------------
    def save(self, path: str) -> None:
        """``trees.npz`` + ``booster.json``, the JAX ``TpuBooster.save`` format."""
        os.makedirs(path, exist_ok=True)
        arrays = dict(feature=self.feature, threshold_value=self.threshold_value,
                      leaf_value=self.leaf_value, gain=self.gain,
                      init_score=self.init_score)
        if self.cover is not None:
            arrays["cover"] = self.cover
        if self.cat_mask is not None:
            arrays["cat_mask"] = self.cat_mask
        np.savez_compressed(os.path.join(path, "trees.npz"), **arrays)
        meta = {
            "max_depth": self.max_depth, "num_model_out": self.num_model_out,
            "objective": self.objective, "num_features": self.num_features,
            "params": self.params, "best_iteration": self.best_iteration,
            "average_output": self.average_output,
            "categorical_features": list(self.categorical_features),
        }
        with open(os.path.join(path, "booster.json"), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, path: str, device="cuda") -> "Booster":
        """Read a directory written by :meth:`save` or by the JAX
        ``TpuBooster.save``."""
        with open(os.path.join(path, "booster.json")) as f:
            meta = json.load(f)
        z = np.load(os.path.join(path, "trees.npz"))
        return cls(z["feature"], z["threshold_value"], z["leaf_value"], z["gain"],
                   init_score=z["init_score"],
                   cover=z["cover"] if "cover" in z.files else None,
                   average_output=meta.get("average_output", False),
                   cat_mask=z["cat_mask"] if "cat_mask" in z.files else None,
                   categorical_features=tuple(meta.get("categorical_features", ())),
                   device=device,
                   **{k: meta[k] for k in
                      ("max_depth", "num_model_out", "objective", "num_features",
                       "params", "best_iteration")})

    def dump_text(self) -> str:
        """Human-readable model dump (the reference's saveNativeModel string
        role — the package's own format, not LightGBM's)."""
        lines = [f"tpu_booster objective={self.objective} trees={self.num_iterations}"
                 f"x{self.num_model_out} max_depth={self.max_depth} "
                 f"num_features={self.num_features}"]
        for t in range(self.num_iterations):
            for k in range(self.num_model_out):
                lines.append(f"tree {t}.{k}:")
                for i in range(self.feature.shape[2]):
                    f_ = int(self.feature[t, k, i])
                    if f_ >= 0 and f_ in self.categorical_features \
                            and self.cat_mask is not None \
                            and self.cat_mask[t, k, i].any():
                        cats = np.nonzero(self.cat_mask[t, k, i])[0].tolist()
                        lines.append(f"  node {i}: f{f_} in {cats} -> {2*i+1},{2*i+2}")
                    elif f_ >= 0:
                        lines.append(f"  node {i}: f{f_} <= "
                                     f"{float(self.threshold_value[t, k, i]):.6g} "
                                     f"-> {2*i+1},{2*i+2}")
                    elif self.leaf_value[t, k, i] != 0.0:
                        lines.append(f"  leaf {i}: {float(self.leaf_value[t, k, i]):.6g}")
        return "\n".join(lines)


TpuBooster = Booster  # the JAX package's name for the same class


def fold_positive_class_weight(y: np.ndarray, w: np.ndarray, *,
                               objective: str, is_unbalance: bool,
                               scale_pos_weight: float) -> np.ndarray:
    """Positive-class reweighting (reference scalePosWeight/isUnbalance),
    folded into the sample-weight vector."""
    if is_unbalance and scale_pos_weight != 1.0:
        # match LightGBM: the two knobs conflict
        raise ValueError("set either is_unbalance or scale_pos_weight, not both")
    if objective != "binary" or not (is_unbalance or scale_pos_weight != 1.0):
        return w
    pos = y > 0
    spw = scale_pos_weight
    if is_unbalance:
        n_pos = max(int(pos.sum()), 1)
        spw = (len(y) - n_pos) / n_pos
    return np.where(pos, w * spw, w)


def _checked_monotone(constraints, num_features: int) -> tuple:
    """Validate per-feature monotone constraints (a wrong-length list must
    not be silently broadcast or clamped)."""
    if constraints is None:
        return ()
    out = tuple(int(c) for c in constraints)
    if len(out) != num_features:
        raise ValueError(f"monotone_constraints has {len(out)} entries for "
                         f"{num_features} features")
    if any(c not in (-1, 0, 1) for c in out):
        raise ValueError(f"monotone_constraints entries must be -1/0/+1: {out}")
    return out if any(out) else ()  # all-zero == unconstrained


# the purposes of the host draws: one numpy stream each, as the JAX keys are
# folded (synapseml_tpu/gbdt/booster.py:584-586)
_BAG, _FEAT, _GOSS = 0, 1, 2


class _Sampler:
    """The random draws of one fit: the row bag (resampled every
    ``bagging_freq`` iterations), the per-tree feature mask and goss's
    sample of small-gradient rows. Each draw is numpy's, from a generator
    seeded by (seed, purpose, iteration), made on the host and copied to
    the device."""

    def __init__(self, seed: int, n: int, f: int, device, *, bagging_fraction: float,
                 bagging_freq: int, do_bag: bool, feature_fraction: float, k_feat: int,
                 other_rate: float, part: "_RowPart"):
        self.seed = int(seed) % (1 << 64)
        self.n, self.f, self.device = n, f, device
        self.bagging_fraction, self.bagging_freq, self.do_bag = (
            bagging_fraction, bagging_freq, do_bag)
        self.feature_fraction, self.k_feat = feature_fraction, k_feat
        self.other_rate = other_rate
        # draws are made for all n rows; a data-parallel fit keeps its own
        self._take = part.take
        self._bag_key, self._bag = None, None
        self._ones = torch.from_numpy(self._take(np.ones(n, np.float32))).to(device)
        self._all_features = torch.ones(f, dtype=torch.bool, device=device)

    def _uniform(self, purpose: int, key: int, size: int) -> np.ndarray:
        return np.random.default_rng([self.seed, purpose, key]).random(size)

    def bag(self, it: int) -> torch.Tensor:
        """(N,) float32 0/1: the rows of this iteration's bag."""
        if not self.do_bag:
            return self._ones
        key = it - it % self.bagging_freq
        if key != self._bag_key:
            drawn = self._uniform(_BAG, key, self.n) < self.bagging_fraction
            self._bag = torch.from_numpy(self._take(drawn.astype(np.float32))).to(self.device)
            self._bag_key = key
        return self._bag

    def features(self, it: int) -> torch.Tensor:
        """(F,) bool: the ``k_feat`` features of lowest random rank."""
        if self.feature_fraction >= 1.0:
            return self._all_features
        order = np.argsort(self._uniform(_FEAT, it, self.f), kind="stable")
        mask = np.zeros(self.f, dtype=bool)
        mask[order[:self.k_feat]] = True
        return torch.from_numpy(mask).to(self.device)

    def goss_other(self, it: int) -> torch.Tensor:
        """(N,) bool: each row drawn with probability ``other_rate``."""
        drawn = self._uniform(_GOSS, it, self.n) < self.other_rate
        return torch.from_numpy(self._take(drawn, False)).to(self.device)


class _RowPart:
    """This process's rows of a fit: all ``n`` without a mesh; over
    ``mesh``'s ``data`` axis rows ``[lo, hi)`` of the inputs padded to a
    multiple of the axis size, or (``group_sizes``) of the unpadded rows cut
    at the query-group boundaries nearest to an even split. ``rows`` is the
    :class:`.hist.RowGroup` the histograms are summed over (None without a
    mesh)."""

    def __init__(self, n: int, mesh=None, group_sizes=None):
        d, r = ((mesh.axis_sizes["data"], mesh.coordinate()["data"]) if mesh is not None
                else (1, 0))
        if group_sizes is None:
            self.pad = (-n) % d
            per = (n + self.pad) // d
            self.bounds = [(i * per, (i + 1) * per) for i in range(d)]
            self.groups = None
        else:
            self.pad = 0
            ends = np.concatenate([[0], np.cumsum(np.asarray(group_sizes, np.int64))])
            cuts = [0]
            for i in range(1, d):
                j = int(np.argmin(np.abs(ends - i * n / d)))
                cuts.append(max(j, cuts[-1]))
            cuts.append(len(group_sizes))
            self.bounds = [(int(ends[a]), int(ends[b])) for a, b in zip(cuts, cuts[1:])]
            self.groups = (cuts[r], cuts[r + 1])
        self.lo, self.hi = self.bounds[r]
        self.rows = (RowGroup(mesh.get_group("data") if mesh.device_mesh is not None else None,
                              n) if mesh is not None else None)

    def take(self, a: np.ndarray, fill=0) -> np.ndarray:
        """This process's rows of an (n, ...) host array, padded rows ``fill``."""
        if self.pad:
            a = np.concatenate([a, np.full((self.pad,) + a.shape[1:], fill, a.dtype)])
        return a[self.lo:self.hi]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's rows of a per-row tensor, in row order."""
        if self.rows is None or self.rows.group is None:
            return t
        import torch.distributed as dist

        most = max(hi - lo for lo, hi in self.bounds)
        padded = torch.zeros((most,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        padded[:t.shape[0]] = t
        parts = [torch.empty_like(padded) for _ in self.bounds]
        dist.all_gather(parts, padded, group=self.rows.group)
        return torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, self.bounds)])


def _check_modes(*, boosting_type, histogram_impl) -> None:
    if boosting_type not in ("gbdt", "goss", "dart", "rf"):
        raise ValueError(f"boosting_type must be gbdt|goss|dart|rf, got {boosting_type!r}")
    if histogram_impl not in HIST_IMPLS:
        raise ValueError(f"histogram_impl must be 'segment', 'onehot' or 'pallas', "
                         f"got {histogram_impl!r}")


def _tree(stacked, k: int) -> T.TreeArrays:
    """Class ``k``'s tree of one iteration's stacked (K, ...) tensors."""
    f, t, v, cm = stacked
    return T.TreeArrays(f[k], t[k], v[k], v[k], v[k], cm[k])


def _forest_delta(iterations, bins, max_depth: int, K: int) -> torch.Tensor:
    """Summed per-class outputs of iterations' trees on binned rows, the
    iterations added in order: a list of stacked (feature, threshold_bin,
    leaf_value, cat_mask) of shape (K, M[, B]) -> (N, K)."""
    out = torch.zeros((bins.shape[0], K), dtype=torch.float32, device=bins.device)
    for stacked in iterations:
        out = out + torch.stack([T.traverse_binned(bins, _tree(stacked, k), max_depth)
                                 for k in range(K)], dim=1)
    return out


def train_booster(features: np.ndarray, labels: np.ndarray, *,
                  objective: str = "regression", num_class: int = 1,
                  num_iterations: int = 100, learning_rate: float = 0.1,
                  num_leaves: int = 31, max_depth: int = -1, max_bin: int = 255,
                  lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                  min_data_in_leaf: int = 20, min_sum_hessian: float = 1e-3,
                  min_gain_to_split: float = 0.0, feature_fraction: float = 1.0,
                  bagging_fraction: float = 1.0, bagging_freq: int = 0,
                  weights: np.ndarray | None = None,
                  group_sizes: np.ndarray | None = None,
                  valid_features: np.ndarray | None = None,
                  valid_labels: np.ndarray | None = None,
                  valid_group_sizes: np.ndarray | None = None,
                  early_stopping_round: int = 0, seed: int = 0,
                  mesh=None, objective_alpha: float | None = None,
                  tweedie_variance_power: float | None = None,
                  callbacks: Sequence[Callable] | None = None,
                  boosting_type: str = "gbdt", top_rate: float = 0.2,
                  other_rate: float = 0.1, drop_rate: float = 0.1,
                  max_drop: int = 50, skip_drop: float = 0.5,
                  monotone_constraints=None, scale_pos_weight: float = 1.0,
                  is_unbalance: bool = False, histogram_impl: str = "segment",
                  categorical_features=None, init_model=None,
                  measures=None, verbose: bool = False, device="cuda") -> Booster:
    """Grow a forest on ``device`` (default ``"cuda"``; a host without a
    card must ask for ``"cpu"``). The binned matrix and the running scores
    stay on the device for the whole run.

    ``boosting_type``: 'gbdt' | 'goss' (gradient one-side sampling, LightGBM
    top_rate/other_rate semantics) | 'dart' (tree dropout with 1/(k+1)
    normalization) | 'rf' (bagged trees on init-score gradients, averaged
    output) — the reference's boostingType surface."""
    _check_modes(boosting_type=boosting_type, histogram_impl=histogram_impl)
    dev = resolve_device(device)
    if measures is None:
        measures = InstrumentationMeasures()
    x = np.asarray(features)
    y = np.asarray(labels, dtype=np.float32)
    n, f = x.shape
    max_depth = T.derive_max_depth(max_depth, num_leaves)

    cat_feats = tuple(sorted(int(i) for i in (categorical_features or ())))
    if cat_feats and not all(0 <= i < f for i in cat_feats):
        raise ValueError(f"categorical_features out of range [0, {f}): {cat_feats}")
    mapper = BinMapper(max_bin=max_bin, seed=seed, categorical=cat_feats)
    with measures.measure("binning"):  # the reference's dataset-prep window
        bins_np = mapper.fit_transform(x, device=dev)  # uint8 when the bins fit, else int32
    w_np = (np.ones(n, np.float32) if weights is None
            else np.asarray(weights, dtype=np.float32))
    w_np = fold_positive_class_weight(y, w_np, objective=objective,
                                      is_unbalance=is_unbalance,
                                      scale_pos_weight=scale_pos_weight).astype(np.float32)

    obj_kw = {}
    if objective_alpha is not None:
        obj_kw["alpha"] = objective_alpha
    if tweedie_variance_power is not None:
        obj_kw["tweedie_variance_power"] = tweedie_variance_power
    o = obj.get_objective(objective, num_class=num_class, **obj_kw)
    if o.name in ("poisson", "tweedie", "gamma") and np.any(y < 0):
        # stock LightGBM fails fast too: negative labels flip the hessian
        # sign under the log link
        raise ValueError(f"{o.name} objective requires non-negative labels")
    K = o.num_model_out
    is_rank = o.name == "lambdarank"
    if is_rank and group_sizes is None:
        raise ValueError("lambdarank requires group_sizes")
    from ..parallel.mesh import MeshConfig, create_mesh

    if isinstance(mesh, MeshConfig):
        mesh = create_mesh(mesh)
    part = _RowPart(n, mesh, group_sizes if is_rank else None)

    with measures.measure("device_transfer"):
        y_all = torch.from_numpy(y).to(dev)
        bins = torch.from_numpy(part.take(bins_np)).to(dev)
        yd = torch.from_numpy(part.take(y)).to(dev)
        # padded rows weigh nothing, so no gradient, hessian or goss draw moves
        wd = torch.from_numpy(part.take(w_np, 0.0)).to(dev)
    n_local = bins.shape[0]

    # ranking: bind the padded-group lambdas
    if is_rank:
        local_groups = np.asarray(group_sizes)[part.groups[0]:part.groups[1]]
        gslot, _ = obj.pad_groups(local_groups)
        # every process pads its groups to the largest group of all, so the
        # pair sums run over the one-process shapes
        gmax = obj.pad_groups(group_sizes)[1]
        gslot_d, ngroups = torch.from_numpy(gslot).to(dev), len(local_groups)

        def grad_hess(scores, yv):
            g, h = obj.lambdarank_grad_hess(scores[:, 0], yv, gslot_d, ngroups, gmax)
            return g[:, None], h[:, None]

        def metric(scores, yv):
            return -obj.ndcg_at_k(scores[:, 0], yv, gslot_d, ngroups, gmax)
    else:
        def grad_hess(scores, yv):
            g, h = o.grad_hess(scores, yv)
            return g.reshape(scores.shape[0], -1), h.reshape(scores.shape[0], -1)

        metric = o.metric

    # warm start (reference modelString continuation): training resumes from
    # the previous booster's raw margins; its trees are prepended to the
    # returned model
    prev = init_model
    if isinstance(prev, (str, bytes)):  # a LightGBM model string
        from .interop import parse_lightgbm_string

        prev = parse_lightgbm_string(prev if isinstance(prev, str) else prev.decode())
    if prev is not None:
        if prev.num_features != f:
            raise ValueError(f"init_model has {prev.num_features} features, data has {f}")
        if prev.num_model_out != K:
            raise ValueError(f"init_model outputs {prev.num_model_out} models "
                             f"per iteration, this objective needs {K}")
        if prev.average_output:
            raise ValueError("continued training from an rf (averaged) model "
                             "is not supported (matches LightGBM)")
        if boosting_type == "rf":
            raise ValueError("boosting_type='rf' cannot continue from "
                             "init_model: averaged output would fold the "
                             "previous full-weight trees into the mean")
        init = torch.from_numpy(np.asarray(prev.init_score, np.float32).reshape(K)).to(dev)
        base = np.asarray(prev.raw_score(x, device=dev), np.float32).reshape(n, K)
        scores = torch.from_numpy(part.take(base)).to(dev)
    else:
        init = o.init_score(y_all).reshape(K).to(torch.float32)  # over every row
        scores = init[None, :].repeat(n_local, 1)

    cfg = T.GrowthConfig(max_depth=max_depth, num_leaves=num_leaves,
                         num_bins=mapper.num_bins, lambda_l1=lambda_l1,
                         lambda_l2=lambda_l2,
                         monotone_constraints=_checked_monotone(monotone_constraints, f),
                         # rf: no shrinkage, output averaged (LightGBM forces
                         # shrinkage 1 in rf mode)
                         learning_rate=1.0 if boosting_type == "rf" else learning_rate,
                         min_data_in_leaf=min_data_in_leaf,
                         min_sum_hessian=min_sum_hessian,
                         min_gain_to_split=min_gain_to_split,
                         hist_impl=histogram_impl, categorical_features=cat_feats)

    # validation scores feed early stopping only; without it they are not kept
    has_valid = (valid_features is not None and valid_labels is not None
                 and early_stopping_round > 0)
    if is_rank and valid_features is not None and valid_group_sizes is None:
        raise ValueError("lambdarank validation requires valid_group_sizes")
    if has_valid:
        vbins = torch.from_numpy(mapper.transform(np.asarray(valid_features),
                                                  device=dev)).to(dev)
        vy = torch.from_numpy(np.asarray(valid_labels, np.float32)).to(dev)
        if prev is not None:  # warm start: eval continues from prev margins too
            vscores = torch.from_numpy(np.asarray(prev.raw_score(
                np.asarray(valid_features, np.float32), device=dev), np.float32)).to(dev)
        else:
            vscores = init[None, :].repeat(vbins.shape[0], 1)
        if is_rank:
            vslot, vmax = obj.pad_groups(valid_group_sizes)
            vslot_d, vngroups = torch.from_numpy(vslot).to(dev), len(valid_group_sizes)

            def vmetric(s, yv):
                return -obj.ndcg_at_k(s[:, 0], yv, vslot_d, vngroups, vmax)
        else:
            vmetric = metric

    if boosting_type == "rf" and not (bagging_fraction < 1.0 and bagging_freq > 0):
        # rf requires bagging (LightGBM errors; the JAX package defaults it on)
        bagging_fraction, bagging_freq = 0.632, 1
    sampler = _Sampler(seed, n, f, dev, bagging_fraction=bagging_fraction,
                       bagging_freq=bagging_freq,
                       do_bag=(bagging_fraction < 1.0 and bagging_freq > 0
                               and boosting_type != "goss"),  # goss replaces bagging
                       feature_fraction=feature_fraction,
                       k_feat=max(1, int(round(f * feature_fraction))),
                       other_rate=other_rate, part=part)
    k_top = max(1, int(round(top_rate * n)))

    def grow_iteration(it: int, scores) -> tuple:
        """One iteration's K trees from ``scores``' gradients, stacked
        (K, ...): feature, threshold_bin, leaf_value, gain, cover, cat_mask."""
        presence, fmask = sampler.bag(it), sampler.features(it)
        g, h = grad_hess(scores, yd)
        if boosting_type == "goss":
            # keep the top_rate fraction by |grad|, sample other_rate of the
            # rest, amplify the sampled small-gradient rows
            gmag = torch.sum(torch.abs(g), dim=1) * wd
            every = part.gather(gmag)  # padded rows are 0
            thresh = torch.sort(every).values[every.shape[0] - k_top]
            is_top = gmag >= thresh
            sel = (is_top | (~is_top & sampler.goss_other(it))).to(torch.float32)
            amp = (1.0 - top_rate) / max(other_rate, 1e-12)
            presence = sel
            w_eff = (wd * torch.where(is_top, 1.0, amp) * sel)[:, None]
        else:
            w_eff = (wd * presence)[:, None]  # bagged-out rows: zero grad AND count
        g = g * w_eff
        h = h * w_eff
        grown = [T.grow_tree(bins, g[:, k].contiguous(), h[:, k].contiguous(), presence, cfg,
                             fmask, part.rows) for k in range(K)]
        return tuple(torch.stack([getattr(t, name) for t in grown])
                     for name in T.TreeArrays._fields)

    best_metric, best_iter, since_best = np.inf, None, 0

    def stop_early(it: int, on_best=None) -> bool:
        """Early-stopping bookkeeping after iteration ``it``; True to stop."""
        nonlocal best_metric, best_iter, since_best
        if not has_valid:
            return False
        v_eval = vscores
        if boosting_type == "rf":  # rf predicts the AVERAGE of its trees
            v_eval = init[None, :] + (vscores - init[None, :]) / (it + 1)
        m = float(vmetric(v_eval, vy))
        if verbose:
            print(f"[{it}] valid {o.metric_name}={m:.6f}")
        if m < best_metric - 1e-12:
            best_metric, best_iter, since_best = m, it + 1, 0
            if on_best is not None:
                on_best()
        else:
            since_best += 1
            if since_best >= early_stopping_round:
                return True
        return False

    forest = []  # per iteration: stacked (K, ...) tensors of TreeArrays' fields
    with measures.measure("training"):
        if boosting_type == "dart":
            # per iteration, drop a random subset of grown trees, fit against
            # the reduced scores, then renormalize: the new tree by 1/(k+1),
            # the dropped ones by k/(k+1). Later drops rescale earlier trees'
            # leaf values, so the best iteration's model is a snapshot.
            drop_rng = np.random.default_rng(seed + 17)
            best_values = None

            def snapshot():
                nonlocal best_values
                best_values = [it_trees[2] for it_trees in forest]

            def walk(its, b):
                return _forest_delta([(t[0], t[1], t[2], t[5]) for t in its], b, max_depth, K)

            for it in range(num_iterations):
                dropped: list[int] = []
                if forest and drop_rng.random() >= skip_drop:
                    mask = drop_rng.random(len(forest)) < drop_rate
                    dropped = [int(i) for i in np.nonzero(mask)[0][:max_drop]]
                    if not dropped:
                        dropped = [int(drop_rng.integers(len(forest)))]
                measures.count("iterations")
                if dropped:
                    measures.count("trees_dropped", len(dropped))
                    delta_drop = walk([forest[i] for i in dropped], bins)
                    scores_red = scores - delta_drop
                    if has_valid:
                        vdelta_drop = walk([forest[i] for i in dropped], vbins)
                        vscores = vscores - vdelta_drop
                else:
                    scores_red = scores
                new = grow_iteration(it, scores_red)
                norm_new = 1.0 / (len(dropped) + 1)
                scores = scores_red + walk([new], bins) * norm_new
                if has_valid:
                    vscores = vscores + walk([new], vbins) * norm_new
                if dropped:
                    norm_drop = len(dropped) / (len(dropped) + 1.0)
                    for i in dropped:
                        old = forest[i]
                        forest[i] = old[:2] + (old[2] * norm_drop,) + old[3:]
                    scores = scores + delta_drop * norm_drop
                    if has_valid:
                        vscores = vscores + vdelta_drop * norm_drop
                forest.append(new[:2] + (new[2] * norm_new,) + new[3:])
                if callbacks:
                    for cb in callbacks:
                        cb(iteration=it, scores=scores)
                if stop_early(it, on_best=snapshot):
                    break
            if best_iter is not None and best_values is not None:
                # exactly the model measured best: its trees with their
                # scales as of that iteration
                forest = [t[:2] + (v,) + t[3:] for t, v in zip(forest[:best_iter],
                                                                best_values[:best_iter])]
        else:
            for it in range(num_iterations):
                measures.count("iterations")
                new = grow_iteration(it, scores)
                forest.append(new)
                stacked = (new[0], new[1], new[2], new[5])
                for k in range(K):
                    if boosting_type != "rf":  # rf: every tree fits the initial scores
                        scores[:, k] += T.traverse_binned(bins, _tree(stacked, k), max_depth)
                    if has_valid:
                        vscores[:, k] += T.traverse_binned(vbins, _tree(stacked, k), max_depth)
                if callbacks:
                    for cb in callbacks:
                        cb(iteration=it, scores=scores)
                if stop_early(it):
                    break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # fold trailing async work into the window

    # one host transfer for the whole forest; bin -> value thresholds on host
    measures.mark("train_done")
    feat_h, thr_bin_h, val_h, gain_h, cover_h, cat_h = (
        torch.stack([it_trees[i] for it_trees in forest]).cpu().numpy() for i in range(6))
    ub = mapper.upper_bound_values()
    thr_val_h = np.where(feat_h >= 0,
                         ub[np.maximum(feat_h, 0), thr_bin_h], 0.0).astype(np.float32)
    cat_mask_h = None
    if cat_feats:
        cat_mask_h = cat_h.astype(np.uint8)  # (T, K, M, B)
        is_cat_lut = np.zeros(f + 1, bool)
        is_cat_lut[list(cat_feats)] = True
        # categorical nodes carry the left SET, not a threshold value
        thr_val_h = np.where(is_cat_lut[np.maximum(feat_h, 0)] & (feat_h >= 0),
                             0.0, thr_val_h).astype(np.float32)
    init_h = init.cpu().numpy()
    params = {"num_iterations": num_iterations, "learning_rate": learning_rate,
              "num_leaves": num_leaves, "max_bin": max_bin, "boosting_type": boosting_type}

    if prev is not None and not hasattr(prev, "feature"):
        # imported model.txt continuation: imported trees use child arrays
        # (depth unbounded, not heap-expressible), so the merge happens in
        # LightGBM format: the new trees export to model.txt and the
        # concatenated forest is one ImportedBooster
        from .interop import parse_lightgbm_string, to_lightgbm_string

        new_b = Booster(feat_h, thr_val_h, val_h, gain_h, cover=cover_h,
                        max_depth=max_depth, num_model_out=K, objective=o.name,
                        init_score=np.zeros(K, np.float32),  # increments on prev margins
                        num_features=f, best_iteration=best_iter,
                        cat_mask=cat_mask_h, categorical_features=cat_feats)
        new_imported = parse_lightgbm_string(to_lightgbm_string(new_b))
        # resume was from best_iteration-truncated margins: stale post-best
        # trees must not ride into the merged forest
        n_prev = (prev.best_iteration or prev.num_iterations) * prev.num_model_out
        merged = dataclasses.replace(prev, trees=list(prev.trees[:n_prev])
                                     + list(new_imported.trees), best_iteration=None)
        merged.device = str(dev)
        merged.bin_mapper = mapper
        merged.train_measures = measures.to_dict()
        return merged
    if prev is not None:
        # prepend the previous forest; a shallower heap layout embeds into a
        # deeper one unchanged (node ids are depth-invariant), so pad node
        # arrays to the larger M with leaf defaults
        depth_all = max(max_depth, prev.max_depth)
        M = 2 ** (depth_all + 1) - 1

        def pad_nodes(a, fill=0.0):
            return np.pad(a, ((0, 0), (0, 0), (0, M - a.shape[2])), constant_values=fill)

        if (prev.cat_mask is None) != (cat_mask_h is None) or (
                prev.cat_mask is not None
                and prev.cat_mask.shape[-1] != cat_mask_h.shape[-1]):
            raise ValueError("continued training with categorical features requires "
                             "the same max_bin/categorical setup as init_model")
        # resume was from best_iteration-truncated margins: slice stale
        # post-best trees away before prepending
        n_prev = prev.best_iteration or prev.num_iterations
        feat_h = np.concatenate([pad_nodes(prev.feature[:n_prev], -1), pad_nodes(feat_h, -1)])
        thr_val_h = np.concatenate([pad_nodes(prev.threshold_value[:n_prev]),
                                    pad_nodes(thr_val_h)])
        val_h = np.concatenate([pad_nodes(prev.leaf_value[:n_prev]), pad_nodes(val_h)])
        gain_h = np.concatenate([pad_nodes(prev.gain[:n_prev]), pad_nodes(gain_h)])
        prev_cover = prev.cover if prev.cover is not None else np.zeros_like(prev.gain)
        cover_h = np.concatenate([pad_nodes(prev_cover[:n_prev]), pad_nodes(cover_h)])
        if cat_mask_h is not None:
            def cm_pad(a):
                return np.pad(a, ((0, 0), (0, 0), (0, M - a.shape[2]), (0, 0)))

            cat_mask_h = np.concatenate([cm_pad(prev.cat_mask[:n_prev]), cm_pad(cat_mask_h)])
        max_depth = depth_all
        best_iter = (n_prev + best_iter) if best_iter else None

    booster = Booster(
        feat_h, thr_val_h, val_h, gain_h, cover=cover_h,
        max_depth=max_depth, num_model_out=K, objective=o.name, init_score=init_h,
        num_features=f, best_iteration=best_iter, average_output=boosting_type == "rf",
        cat_mask=cat_mask_h, categorical_features=cat_feats, device=str(dev), params=params)
    booster.bin_mapper = mapper
    booster.train_measures = measures.to_dict()
    return booster
