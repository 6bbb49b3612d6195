"""Booster — boosting orchestration, prediction, persistence.

Counterpart of ``synapseml_tpu/gbdt/booster.py`` (``TpuBooster``,
``train_booster``; reference ``booster/LightGBMBooster.scala`` and the
training loop of ``TrainUtils.scala``). Training keeps the binned matrix
(uint8 when the bins fit, where the JAX package widens to int32), the
labels, weights and running scores on the device for the whole run, and
grows every tree there; the forest comes back to the host in one transfer
at the end. The JAX package's two training programs — one scan over all
iterations, and a host loop when early stopping needs a decision per
iteration — are one Python loop here.

A :class:`Booster` holds host numpy arrays, so it pickles with no device in
it; device copies of its trees are cached per (device, iterations) and
dropped on pickling. Its on-disk format (``trees.npz`` + ``booster.json``)
is the JAX ``TpuBooster``'s: either package loads what the other saved.

Ported: ``boosting_type='gbdt'`` with weights, ``scale_pos_weight`` /
``is_unbalance``, monotone constraints, validation with early stopping and
the three histogram backends. Refused with ``NotImplementedError`` until a
later slice: goss, dart and rf, row bagging and feature subsampling (they
draw ``jax.random`` bits that torch cannot reproduce), categorical
features, lambdarank, continued training (``init_model``), multi-device
meshes, out-of-core training and the fused sweep.
"""

from __future__ import annotations

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
from .hist import HIST_IMPLS

__all__ = ["Booster", "train_booster", "train_booster_from_source",
           "fold_positive_class_weight", "resolve_device", "device_type"]

_PREDICT_ROW_CHUNK = 1 << 17  # rows per forest walk: bounds the (rows, trees) index tensors


def resolve_device(spec) -> torch.device:
    """``torch.device(spec)``, refusing ``cuda`` on a host without a card."""
    if device_type(spec) not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', got {spec!r}")
    return core_device.resolve_device("Booster", spec)


def train_booster_from_source(source, **kwargs) -> "Booster":
    """Out-of-core training from a streamed source: not ported yet."""
    raise NotImplementedError("train_booster_from_source (out-of-core GBDT over a "
                              "ShardedSource) is not ported yet: it needs the data plane")


class Booster:
    """A trained forest. Arrays are host numpy, stacked (iterations, K, M)."""

    def __init__(self, feature: np.ndarray, threshold_value: np.ndarray,
                 leaf_value: np.ndarray, gain: np.ndarray, *, max_depth: int,
                 num_model_out: int, objective: str, init_score: np.ndarray,
                 num_features: int, params: dict | None = None,
                 best_iteration: int | None = None,
                 cover: np.ndarray | None = None,
                 average_output: bool = False, device="cuda"):
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
        """(T*K, M)-shaped feature/threshold/leaf tensors of the first
        ``n_it`` iterations, class-major (tree t of class k at row k*T + t),
        cached on ``device``."""
        key = (str(device), n_it)
        if key not in self._device_cache:
            def stacked(a):
                a = np.ascontiguousarray(np.swapaxes(a[:n_it], 0, 1))  # (K, T, M)
                return torch.from_numpy(a.reshape(-1, a.shape[-1])).to(device)

            self._device_cache[key] = (stacked(self.feature), stacked(self.threshold_value),
                                       stacked(self.leaf_value))
        return self._device_cache[key]

    def _raw(self, x: torch.Tensor, n_it: int) -> torch.Tensor:
        feat, thr, val = self._trees_on(x.device, n_it)
        K = self.num_model_out
        outs = [T.predict_raw_forest(x, feat[k * n_it:(k + 1) * n_it],
                                     thr[k * n_it:(k + 1) * n_it],
                                     val[k * n_it:(k + 1) * n_it], self.max_depth)
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
                              np.asarray(features, np.float64))
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
            return T.leaf_index_forest(x, feat, thr, self.max_depth).to(torch.int32).cpu().numpy()

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
        np.savez_compressed(os.path.join(path, "trees.npz"), **arrays)
        meta = {
            "max_depth": self.max_depth, "num_model_out": self.num_model_out,
            "objective": self.objective, "num_features": self.num_features,
            "params": self.params, "best_iteration": self.best_iteration,
            "average_output": self.average_output, "categorical_features": [],
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
        if "cat_mask" in z.files or meta.get("categorical_features"):
            raise NotImplementedError("boosters with categorical splits are not "
                                      "ported yet")
        return cls(z["feature"], z["threshold_value"], z["leaf_value"], z["gain"],
                   init_score=z["init_score"],
                   cover=z["cover"] if "cover" in z.files else None,
                   average_output=meta.get("average_output", False), device=device,
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
                    if f_ >= 0:
                        lines.append(f"  node {i}: f{f_} <= "
                                     f"{float(self.threshold_value[t, k, i]):.6g} "
                                     f"-> {2*i+1},{2*i+2}")
                    elif self.leaf_value[t, k, i] != 0.0:
                        lines.append(f"  leaf {i}: {float(self.leaf_value[t, k, i]):.6g}")
        return "\n".join(lines)


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


def _refuse_unported(*, boosting_type, feature_fraction, bagging_fraction, bagging_freq,
                     group_sizes, categorical_features, init_model, mesh,
                     histogram_impl) -> None:
    if boosting_type not in ("gbdt", "goss", "dart", "rf"):
        raise ValueError(f"boosting_type must be gbdt|goss|dart|rf, got {boosting_type!r}")
    if boosting_type != "gbdt":
        raise NotImplementedError(f"boosting_type={boosting_type!r} is not ported yet "
                                  "(only 'gbdt'): it draws jax.random bits")
    if bagging_fraction < 1.0 and bagging_freq > 0:
        raise NotImplementedError("row bagging (bagging_fraction < 1 with bagging_freq "
                                  "> 0) is not ported yet: it draws jax.random bits")
    if feature_fraction < 1.0:
        raise NotImplementedError("feature_fraction < 1 is not ported yet: it draws "
                                  "jax.random bits")
    if group_sizes is not None:
        raise NotImplementedError("group_sizes (lambdarank) is not ported yet")
    if categorical_features:
        raise NotImplementedError("categorical_features are not ported yet")
    if init_model is not None:
        raise NotImplementedError("init_model (continued training) is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh (multi-device training) is not ported yet")
    if histogram_impl not in HIST_IMPLS:
        raise ValueError(f"histogram_impl must be 'segment', 'onehot' or 'pallas', "
                         f"got {histogram_impl!r}")


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
                  early_stopping_round: int = 0, seed: int = 0,
                  mesh=None, objective_alpha: float | None = None,
                  tweedie_variance_power: float | None = None,
                  callbacks: Sequence[Callable] | None = None,
                  boosting_type: str = "gbdt",
                  monotone_constraints=None, scale_pos_weight: float = 1.0,
                  is_unbalance: bool = False, histogram_impl: str = "segment",
                  categorical_features=None, init_model=None,
                  measures=None, verbose: bool = False, device="cuda") -> Booster:
    """Grow a forest on ``device`` (default ``"cuda"``; a host without a
    card must ask for ``"cpu"``). The binned matrix and the running scores
    stay on the device for the whole run."""
    _refuse_unported(boosting_type=boosting_type, feature_fraction=feature_fraction,
                     bagging_fraction=bagging_fraction, bagging_freq=bagging_freq,
                     group_sizes=group_sizes, categorical_features=categorical_features,
                     init_model=init_model, mesh=mesh, histogram_impl=histogram_impl)
    dev = resolve_device(device)
    if measures is None:
        measures = InstrumentationMeasures()
    x = np.asarray(features)
    y = np.asarray(labels, dtype=np.float32)
    n, f = x.shape
    max_depth = T.derive_max_depth(max_depth, num_leaves)

    mapper = BinMapper(max_bin=max_bin, seed=seed)
    with measures.measure("binning"):  # the reference's dataset-prep window
        bins_np = mapper.fit_transform(x)  # uint8 when the bins fit, else int32
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

    with measures.measure("device_transfer"):
        bins = torch.from_numpy(bins_np).to(dev)
        yd = torch.from_numpy(y).to(dev)
        wd = torch.from_numpy(w_np).to(dev)
        presence = torch.ones(n, dtype=torch.float32, device=dev)
    init = o.init_score(yd).reshape(K).to(torch.float32)
    scores = init[None, :].repeat(n, 1)

    cfg = T.GrowthConfig(max_depth=max_depth, num_leaves=num_leaves,
                         num_bins=mapper.num_bins, lambda_l1=lambda_l1,
                         lambda_l2=lambda_l2,
                         monotone_constraints=_checked_monotone(monotone_constraints, f),
                         learning_rate=learning_rate,
                         min_data_in_leaf=min_data_in_leaf,
                         min_sum_hessian=min_sum_hessian,
                         min_gain_to_split=min_gain_to_split,
                         hist_impl=histogram_impl)
    feat_mask = torch.ones(f, dtype=torch.bool, device=dev)

    # validation scores feed early stopping only; without it they are not kept
    has_valid = (valid_features is not None and valid_labels is not None
                 and early_stopping_round > 0)
    if has_valid:
        vbins = torch.from_numpy(mapper.transform(np.asarray(valid_features))).to(dev)
        vy = torch.from_numpy(np.asarray(valid_labels, np.float32)).to(dev)
        vscores = init[None, :].repeat(vbins.shape[0], 1)

    best_metric, best_iter, since_best = np.inf, None, 0
    trees = []
    with measures.measure("training"):
        for it in range(num_iterations):
            measures.count("iterations")
            # g/h once per iteration, before the K class trees
            g, h = o.grad_hess(scores, yd)
            w_eff = (wd * presence)[:, None]
            g = g.reshape(n, -1) * w_eff
            h = h.reshape(n, -1) * w_eff
            per_class = []
            for k in range(K):
                tree = T.grow_tree(bins, g[:, k].contiguous(), h[:, k].contiguous(),
                                   presence, cfg, feat_mask)
                scores[:, k] += T.traverse_binned(bins, tree, max_depth)
                if has_valid:
                    vscores[:, k] += T.traverse_binned(vbins, tree, max_depth)
                per_class.append(tree)
            trees.append(per_class)
            if callbacks:
                for cb in callbacks:
                    cb(iteration=it, scores=scores)
            if has_valid:
                m = float(o.metric(vscores, vy))
                if verbose:
                    print(f"[{it}] valid {o.metric_name}={m:.6f}")
                if m < best_metric - 1e-12:
                    best_metric, best_iter, since_best = m, it + 1, 0
                else:
                    since_best += 1
                    if since_best >= early_stopping_round:
                        break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # fold trailing async work into the window

    # one host transfer for the whole forest; bin -> value thresholds on host
    measures.mark("train_done")

    def stacked(field):
        return torch.stack([torch.stack([getattr(t, field) for t in per_class])
                            for per_class in trees]).cpu().numpy()

    feat_h, thr_bin_h = stacked("feature"), stacked("threshold_bin")
    ub = mapper.upper_bound_values()
    thr_val_h = np.where(feat_h >= 0,
                         ub[np.maximum(feat_h, 0), thr_bin_h], 0.0).astype(np.float32)
    booster = Booster(
        feat_h, thr_val_h, stacked("leaf_value"), stacked("gain"), cover=stacked("cover"),
        max_depth=max_depth, num_model_out=K, objective=o.name,
        init_score=init.cpu().numpy(), num_features=f, best_iteration=best_iter,
        device=str(dev),
        params={"num_iterations": num_iterations, "learning_rate": learning_rate,
                "num_leaves": num_leaves, "max_bin": max_bin,
                "boosting_type": boosting_type})
    booster.bin_mapper = mapper
    booster.train_measures = measures.to_dict()
    return booster
