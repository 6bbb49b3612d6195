"""LightGBM model-string interop: emit and parse LightGBM ``model.txt``.

Counterpart of ``synapseml_tpu/gbdt/interop.py`` (reference
``booster/LightGBMBooster.scala``: ``saveNativeModel`` and the
``modelString`` param that warm-starts training and rehydrates models):

  * :func:`to_lightgbm_string` — serialize a :class:`~.booster.Booster` in
    LightGBM's text format (child-array trees, ``Tree=N`` blocks), byte for
    byte the string the JAX package writes for the same booster;
  * :func:`parse_lightgbm_string` / :class:`ImportedBooster` — load a model
    produced by real LightGBM (arbitrary tree shapes, not just the heap
    layout) and score it with a torch walk of every tree at once on the
    booster's device (``"cuda"`` unless the caller asks for the CPU), so
    existing LightGBM models migrate in.

LightGBM node encoding recap: per tree, arrays index INTERNAL nodes
(``num_leaves - 1`` of them); ``left_child``/``right_child`` entries >= 0 are
internal node ids, negative entries are leaves encoded as ``~leaf_idx``
(= ``-leaf-1``). ``decision_type`` bit 1 = categorical (the node's
``threshold`` is then an ordinal into ``cat_boundaries``, and
``cat_threshold`` holds 32-bit bitset words of member categories — members
route left, NaN/out-of-range/non-members right), bit 2 = default-left
(missing values go left).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["to_lightgbm_string", "parse_lightgbm_string", "ImportedBooster"]

_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2
# decision_type bits 2-3: missing_type (0=None, 1=Zero, 2=NaN)
_MISSING_NONE, _MISSING_ZERO, _MISSING_NAN = 0, 1, 2
_ZERO_THRESHOLD = 1e-35


# ---------------------------------------------------------------------------
# export: heap trees -> LightGBM child arrays
# ---------------------------------------------------------------------------

def _mask_to_words(mask: np.ndarray) -> list[int]:
    """Bin-membership mask -> LightGBM 32-bit bitset words."""
    cats = np.nonzero(mask)[0]
    n_words = int(cats.max()) // 32 + 1 if cats.size else 1
    words = [0] * n_words
    for c in cats:
        words[int(c) // 32] |= 1 << (int(c) % 32)
    return words


def _heap_to_children(feature: np.ndarray, threshold: np.ndarray,
                      leaf_value: np.ndarray, gain: np.ndarray,
                      cat_mask: np.ndarray | None = None):
    """One heap tree -> (split_feature, split_gain, threshold, left, right,
    leaf_values, decision_type, cat_boundaries, cat_threshold) in LightGBM
    encoding. Categorical nodes (nonempty cat_mask row) get decision_type
    bit 1 and a threshold that is their ordinal into cat_boundaries."""
    internal: list[int] = []          # heap idx of internal nodes, BFS order
    leaves: list[int] = []            # heap idx of leaf nodes, BFS order
    index_of: dict[int, int] = {}

    order = [0]
    while order:
        h = order.pop(0)
        if feature[h] >= 0:
            index_of[h] = len(internal)
            internal.append(h)
            order.append(2 * h + 1)
            order.append(2 * h + 2)
        else:
            index_of[h] = ~len(leaves)
            leaves.append(h)
    if not internal:  # single-leaf tree
        return ([], [], [], [], [], [float(leaf_value[0])], [], [0], [])

    left = [index_of[2 * h + 1] for h in internal]
    right = [index_of[2 * h + 2] for h in internal]
    thr_out, dt_out = [], []
    cat_boundaries, cat_words = [0], []
    for h in internal:
        is_cat = cat_mask is not None and bool(cat_mask[h].any())
        if is_cat:
            words = _mask_to_words(cat_mask[h])
            thr_out.append(float(len(cat_boundaries) - 1))  # ordinal
            # keep missing_type=NaN bits alongside the categorical bit so
            # stock LightGBM treats NaN as missing (-> right), matching our
            # routing, instead of coercing it to category 0
            dt_out.append(_CAT_MASK | (_MISSING_NAN << 2))
            cat_words.extend(words)
            cat_boundaries.append(len(cat_words))
        else:
            thr_out.append(float(threshold[h]))
            # NaN routes right: missing_type=NaN (bits 2-3 = 2), default_left=0
            dt_out.append(_MISSING_NAN << 2)
    return ([int(feature[h]) for h in internal],
            [float(gain[h]) for h in internal],
            thr_out, left, right,
            [float(leaf_value[h]) for h in leaves],
            dt_out, cat_boundaries, cat_words)


def to_lightgbm_string(booster) -> str:
    """Serialize a TpuBooster (heap trees) or ImportedBooster (child arrays)
    as a LightGBM model.txt string.

    ``init_score`` is folded into each class's FIRST tree (LightGBM's
    boost_from_average bakes the prior into leaf values the same way)."""
    if isinstance(booster, ImportedBooster):
        return _imported_to_string(booster)
    K = booster.num_model_out
    T = booster.best_iteration or booster.num_iterations
    # LightGBM objective strings; link-carrying regressions pass through by
    # name so the round-trip (and stock LightGBM) keep the link function
    obj = {"binary": "binary sigmoid:1",
           "multiclass": f"multiclass num_class:{K}",
           "lambdarank": "lambdarank"}.get(booster.objective, booster.objective)
    out = [
        "tree", "version=v3",
        f"num_class={K if booster.objective == 'multiclass' else 1}",
        f"num_tree_per_iteration={K}",
        "label_index=0",
        f"max_feature_idx={booster.num_features - 1}",
        f"objective={obj}",
        "feature_names=" + " ".join(f"Column_{i}" for i in range(booster.num_features)),
        "feature_infos=" + " ".join(["[-inf:inf]"] * booster.num_features),
    ]
    if getattr(booster, "average_output", False):
        # stock LightGBM writes this flag BARE and reads it by key presence
        out.append("average_output")
    out.append("")
    for t in range(T):
        for k in range(K):
            cm = (None if getattr(booster, "cat_mask", None) is None
                  else booster.cat_mask[t, k])
            (feat, gain, thr, left, right, leaf_vals, dt, cat_b,
             cat_w) = _heap_to_children(
                booster.feature[t, k], booster.threshold_value[t, k],
                booster.leaf_value[t, k], booster.gain[t, k], cat_mask=cm)
            if t == 0:
                adj = float(booster.init_score[k])
                if getattr(booster, "average_output", False):
                    # rf predict divides the tree sum by T before adding init;
                    # folding init*T keeps (init*T + sum)/T == init + sum/T
                    adj *= T
                leaf_vals = [v + adj for v in leaf_vals]
            n_leaves = len(leaf_vals)
            n_cat = len(cat_b) - 1 if cat_w else 0
            blk = [f"Tree={t * K + k}", f"num_leaves={n_leaves}",
                   f"num_cat={n_cat}"]
            if feat:
                blk += [
                    "split_feature=" + " ".join(map(str, feat)),
                    "split_gain=" + " ".join(f"{g:.17g}" for g in gain),
                    "threshold=" + " ".join(f"{v:.17g}" for v in thr),
                    "decision_type=" + " ".join(map(str, dt)),
                    "left_child=" + " ".join(map(str, left)),
                    "right_child=" + " ".join(map(str, right)),
                ]
                if n_cat:
                    blk += ["cat_boundaries=" + " ".join(map(str, cat_b)),
                            "cat_threshold=" + " ".join(map(str, cat_w))]
            blk += ["leaf_value=" + " ".join(f"{v:.17g}" for v in leaf_vals),
                    "shrinkage=1", ""]
            out += blk
    out += ["end of trees", "", "parameters:", "end of parameters", ""]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# import: LightGBM model.txt -> jitted predictor
# ---------------------------------------------------------------------------

@dataclass
class _Tree:
    split_feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_value: np.ndarray
    default_left: np.ndarray
    missing_type: np.ndarray
    # (n_internal, B) uint8 member-category mask; all-zero rows = numerical
    cat_member: np.ndarray | None = None


@dataclass
class ImportedBooster:
    """A LightGBM-format forest scored by a torch child-array walk.
    API-compatible with :class:`~.booster.Booster`'s scoring surface so it
    slots into the LightGBM*Model transformers (``booster=`` param)."""

    trees: list[_Tree]
    num_model_out: int
    objective: str
    num_features: int
    average_output: bool = False
    init_score: np.ndarray = field(default_factory=lambda: np.zeros(1, np.float32))
    best_iteration: int | None = None
    device: str = "cuda"  # where scoring runs unless a call says otherwise

    @property
    def num_iterations(self) -> int:
        return len(self.trees) // max(self.num_model_out, 1)

    def _packed(self):
        """Pad per-tree arrays to a common internal-node count and stack."""
        if getattr(self, "_packed_cache", None) is None:
            m = max(max(len(t.split_feature), 1) for t in self.trees)
            L = max(max(len(t.leaf_value), 1) for t in self.trees)

            def pad(a, n, fill):
                a = np.asarray(a)
                return np.concatenate([a, np.full(n - len(a), fill, a.dtype)]) \
                    if len(a) < n else a

            packed = tuple(
                np.stack([pad(getattr(t, name), m if name != "leaf_value" else L,
                              fill) for t in self.trees])
                for name, fill in (("split_feature", 0), ("threshold", 0.0),
                                   ("left", -1), ("right", -1),
                                   ("leaf_value", 0.0), ("default_left", 0),
                                   ("missing_type", 0)))
            B = max((t.cat_member.shape[1] for t in self.trees
                     if t.cat_member is not None), default=0)
            cmem = None
            if B:
                cmem = np.zeros((len(self.trees), m, B), np.uint8)
                for i, t in enumerate(self.trees):
                    if t.cat_member is not None and t.cat_member.size:
                        ni, bi = t.cat_member.shape
                        cmem[i, :ni, :bi] = t.cat_member
            self._packed_cache = packed + (cmem,)
        return self._packed_cache

    def raw_score(self, features: np.ndarray, num_iterations: int | None = None,
                  device=None) -> np.ndarray:
        """(N, K) raw margins from one walk of the first ``num_iterations``
        iterations' trees on ``device`` (default: the booster's)."""
        from .booster import resolve_device

        dev = resolve_device(device or self.device)
        feat, thr, left, right, leafv, dleft, mtype, cmem = self._packed()
        K = self.num_model_out
        n_it = num_iterations or self.best_iteration or self.num_iterations
        n_it = min(n_it, self.num_iterations)
        nt = n_it * K

        def on(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a[:nt], dtype=dtype)).to(dev)

        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)).to(dev)
            total = _walk_forest(x, on(feat, np.int64), on(thr, np.float32),
                                 on(left, np.int64), on(right, np.int64),
                                 on(leafv, np.float32), on(dleft), on(mtype),
                                 None if cmem is None else on(cmem), K, n_it,
                                 int(np.ceil(np.log2(leafv.shape[1] + 1))) + 2)
            if self.average_output:
                total = total / n_it
            total = total + torch.from_numpy(
                np.asarray(self.init_score, np.float32)).to(dev)[None, :]
            return total.cpu().numpy()

    def predict(self, features: np.ndarray, num_iterations: int | None = None,
                device=None) -> np.ndarray:
        from . import objectives as obj

        s = self.raw_score(features, num_iterations, device)
        try:
            o = obj.get_objective(self.objective, num_class=max(self.num_model_out, 2))
        except (KeyError, ValueError):
            o = obj.get_objective("regression", num_class=2)
        return o.transform(torch.from_numpy(s)).numpy()


def _walk_forest(x, feat, thr, left, right, leafv, dleft, mtype, cmem, K: int,
                 n_it: int, max_depth: int):
    """Sum leaf values over trees [0, n_it*K), per class K, every tree walked
    at once. Node state is the LightGBM encoding itself: >= 0 internal,
    negative = settled leaf. Trees of a class are added in iteration order."""
    from .trees import cat_route_left

    N, nt = x.shape[0], feat.shape[0]
    m = feat.shape[1]
    offset = torch.arange(nt, device=x.device)[None, :] * m
    flat_f, flat_t = feat.reshape(-1), thr.reshape(-1)
    flat_l, flat_r = left.reshape(-1), right.reshape(-1)
    flat_d, flat_m = dleft.reshape(-1), mtype.reshape(-1)
    if cmem is not None:
        cm = cmem.reshape(nt * m, -1)
        node_is_cat = (cm > 0).any(dim=1)
    node = torch.zeros((N, nt), dtype=torch.int64, device=x.device)
    for _ in range(max_depth + leafv.shape[1]):
        live = node >= 0
        flat = torch.clamp(node, min=0) + offset
        v = torch.gather(x, 1, flat_f[flat])
        mt = flat_m[flat]
        # missing_type semantics: Zero -> |v|<=1e-35 or NaN is missing;
        # NaN -> NaN is missing; None -> NaN still falls to the default
        is_nan = torch.isnan(v)
        is_missing = torch.where(mt == _MISSING_ZERO,
                                 is_nan | (torch.abs(v) <= _ZERO_THRESHOLD), is_nan)
        go_left = torch.where(is_missing, flat_d[flat] > 0, v <= flat_t[flat])
        if cmem is not None:
            go_left = cat_route_left(v, go_left, node_is_cat[flat], cm, flat)
        nxt = torch.where(go_left, flat_l[flat], flat_r[flat])
        node = torch.where(live, nxt, node)
    leaf_idx = torch.clamp(~node, min=0)  # ~leaf encoding; live nodes can't remain
    vals = torch.gather(leafv, 1, leaf_idx.T).T  # (N, nt)
    outs = []
    for k in range(K):
        acc = torch.zeros(N, dtype=torch.float32, device=x.device)
        for t in range(n_it):
            acc = acc + vals[:, t * K + k]
        outs.append(acc)
    return torch.stack(outs, dim=1)


def _parse_block(lines: list[str]) -> dict:
    out = {}
    for ln in lines:
        if "=" in ln:
            k, v = ln.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_lightgbm_string(text: str) -> ImportedBooster:
    """Parse a LightGBM model.txt (stock LightGBM or our export)."""
    header_lines: list[str] = []
    bare_flags: set[str] = set()
    tree_blocks: list[list[str]] = []
    cur: list[str] | None = None
    for ln in text.splitlines():
        s = ln.strip()
        if s.startswith("Tree="):
            cur = [s]
            tree_blocks.append(cur)
        elif s == "end of trees":
            cur = None
        elif cur is not None:
            cur.append(s)
        elif s:
            if "=" not in s:
                bare_flags.add(s)  # stock writes e.g. 'average_output' bare
            header_lines.append(s)
    head = _parse_block(header_lines)
    objective = head.get("objective", "regression")
    num_tpi = int(head.get("num_tree_per_iteration", 1))
    num_features = int(head.get("max_feature_idx", 0)) + 1

    trees: list[_Tree] = []
    for blk in tree_blocks:
        d = _parse_block(blk)
        n_leaves = int(d.get("num_leaves", 1))
        if "split_feature" in d and n_leaves > 1:
            dt = [int(t) for t in d["decision_type"].split()]
            thresholds = np.asarray(d["threshold"].split(), np.float64)
            cat_member = None
            n_cat = int(d.get("num_cat", 0))
            if n_cat > 0:
                bounds = [int(v) for v in d["cat_boundaries"].split()]
                words = [int(v) for v in d["cat_threshold"].split()]
                max_words = max(bounds[i + 1] - bounds[i] for i in range(n_cat))
                B = 32 * max_words
                cat_member = np.zeros((len(dt), B), np.uint8)
                for j, t_dt in enumerate(dt):
                    if t_dt & _CAT_MASK:
                        o = int(thresholds[j])
                        for wi, w in enumerate(words[bounds[o]:bounds[o + 1]]):
                            w &= 0xFFFFFFFF
                            for b in range(32):
                                if (w >> b) & 1:
                                    cat_member[j, wi * 32 + b] = 1
            trees.append(_Tree(
                split_feature=np.asarray(d["split_feature"].split(), np.int32),
                threshold=thresholds,
                left=np.asarray(d["left_child"].split(), np.int32),
                right=np.asarray(d["right_child"].split(), np.int32),
                leaf_value=np.asarray(d["leaf_value"].split(), np.float64),
                default_left=np.asarray(
                    [(t & _DEFAULT_LEFT_MASK) > 0 for t in dt], np.int32),
                missing_type=np.asarray([(t >> 2) & 3 for t in dt], np.int32),
                cat_member=cat_member))
        else:
            trees.append(_Tree(
                split_feature=np.zeros(0, np.int32),
                threshold=np.zeros(0, np.float64),
                left=np.zeros(0, np.int32), right=np.zeros(0, np.int32),
                leaf_value=np.asarray(d["leaf_value"].split(), np.float64),
                default_left=np.zeros(0, np.int32),
                missing_type=np.zeros(0, np.int32)))

    first = objective.split()[0] if objective else "regression"
    if first == "multiclass":
        K, base = num_tpi, "multiclass"
    elif first == "binary":
        K, base = 1, "binary"
    elif first == "lambdarank":
        K, base = 1, "lambdarank"
    elif first in ("regression_l1", "huber", "poisson", "quantile",
                   "tweedie", "gamma", "mape"):
        K, base = 1, first  # link-carrying regression objectives
    else:
        K, base = 1, "regression"
    avg = (head.get("average_output", "0") == "1"
           or "average_output" in bare_flags)
    return ImportedBooster(trees=trees, num_model_out=K, objective=base,
                           num_features=num_features, average_output=avg,
                           init_score=np.zeros(K, np.float32))


def _imported_to_string(b: "ImportedBooster") -> str:
    """Re-serialize an imported child-array forest (migrate-in models persist
    too — saveNativeModel parity for ImportedBooster-backed transformers)."""
    K = b.num_model_out
    obj = {"binary": "binary sigmoid:1",
           "multiclass": f"multiclass num_class:{K}",
           "lambdarank": "lambdarank"}.get(b.objective, b.objective)
    out = ["tree", "version=v3",
           f"num_class={K if b.objective == 'multiclass' else 1}",
           f"num_tree_per_iteration={K}", "label_index=0",
           f"max_feature_idx={b.num_features - 1}",
           f"objective={obj}",
           "feature_names=" + " ".join(f"Column_{i}" for i in range(b.num_features)),
           "feature_infos=" + " ".join(["[-inf:inf]"] * b.num_features)]
    if b.average_output:
        out.append("average_output")
    out.append("")
    for i, t in enumerate(b.trees):
        cat_b, cat_w, dts, thr_out = [0], [], [], []
        for j in range(len(t.split_feature)):
            is_cat = (t.cat_member is not None and j < len(t.cat_member)
                      and bool(t.cat_member[j].any()))
            if is_cat:
                words = _mask_to_words(t.cat_member[j])
                thr_out.append(float(len(cat_b) - 1))
                dts.append(_CAT_MASK
                           | int(_DEFAULT_LEFT_MASK * bool(t.default_left[j]))
                           | (int(t.missing_type[j]) << 2))
                cat_w.extend(words)
                cat_b.append(len(cat_w))
            else:
                thr_out.append(float(t.threshold[j]))
                dts.append(int(_DEFAULT_LEFT_MASK * bool(t.default_left[j]))
                           | (int(t.missing_type[j]) << 2))
        n_cat = len(cat_b) - 1 if cat_w else 0
        blk = [f"Tree={i}", f"num_leaves={len(t.leaf_value)}",
               f"num_cat={n_cat}"]
        if len(t.split_feature):
            blk += ["split_feature=" + " ".join(map(str, t.split_feature)),
                    "split_gain=" + " ".join(["0"] * len(t.split_feature)),
                    "threshold=" + " ".join(f"{v:.17g}" for v in thr_out),
                    "decision_type=" + " ".join(map(str, dts)),
                    "left_child=" + " ".join(map(str, t.left)),
                    "right_child=" + " ".join(map(str, t.right))]
            if n_cat:
                blk += ["cat_boundaries=" + " ".join(map(str, cat_b)),
                        "cat_threshold=" + " ".join(map(str, cat_w))]
        blk += ["leaf_value=" + " ".join(f"{v:.17g}" for v in t.leaf_value),
                "shrinkage=1", ""]
        out += blk
    out += ["end of trees", "", "parameters:", "end of parameters", ""]
    return "\n".join(out)
