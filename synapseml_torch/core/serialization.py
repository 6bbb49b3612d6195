"""Stage persistence: metadata.json + out-of-band complex params.

Counterpart of ``synapseml_tpu/core/serialization.py`` with the same on-disk
format: JSON metadata for simple params, one npz + structure JSON per
array pytree, pickle for everything else (a ``TransformerConfig`` holding a
``torch.dtype`` pickles as is). Torch tensors are accepted as pytree leaves
and saved as numpy arrays, so a saved stage loads on a host with or without
a card.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
from typing import Any

import numpy as np
import torch

__all__ = ["save_stage", "load_stage", "prepare_dir", "save_pytree",
           "load_pytree", "flatten_pytree", "tree_structure", "rebuild_pytree"]


def prepare_dir(path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_pytree(tree: Any, prefix: str = "", leaf_fn=_to_numpy) -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_pytree(v, f"{prefix}{k}/", leaf_fn))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_pytree(v, f"{prefix}{i}/", leaf_fn))
    else:
        out[prefix.rstrip("/")] = leaf_fn(tree)
    return out


def flatten_pytree(tree: Any, prefix: str = "", leaf_fn=_to_numpy) -> dict[str, Any]:
    """Slash-joined leaf path -> ``leaf_fn(leaf)``: the one naming scheme of
    the npz format, shared by the sharded checkpoint writer (which keeps
    raw leaves with an identity ``leaf_fn``)."""
    return _flatten_pytree(tree, prefix, leaf_fn)


def tree_structure(tree: Any) -> Any:
    """The structure JSON of :func:`save_pytree` (``state.tree.json``)."""
    return _tree_structure(tree)


def _tree_structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__kind__": kind, "items": [_tree_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def save_pytree(tree: Any, path: str) -> None:
    """Save a (possibly nested dict) pytree of arrays as one npz + structure JSON."""
    np.savez(path + ".npz", **_flatten_pytree(tree))
    with open(path + ".tree.json", "w") as f:
        json.dump(_tree_structure(tree), f)


def rebuild_pytree(structure: Any, flat: Any) -> Any:
    """Inverse of the flatten: ``flat`` maps slash-joined leaf paths to
    arrays (an open npz works)."""

    def rebuild(node, prefix=""):
        kind = node["__kind__"]
        if kind == "dict":
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node["items"].items()}
        if kind in ("list", "tuple"):
            seq = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(node["items"])]
            return seq if kind == "list" else tuple(seq)
        return flat[prefix.rstrip("/")]

    return rebuild(structure)


def load_pytree(path: str) -> Any:
    with np.load(path + ".npz", allow_pickle=False) as data, \
            open(path + ".tree.json") as f:
        return rebuild_pytree(json.load(f), data)


def _is_array_pytree(v: Any) -> bool:
    if isinstance(v, (bytes, bytearray, str)):
        return False  # npz round-trips these as 0-d S/U arrays: pickle instead
    if isinstance(v, (np.ndarray, torch.Tensor)) or np.isscalar(v):
        return True
    if isinstance(v, dict):
        # non-str keys would be stringified by the npz flatten and not restored
        return (bool(v) and all(isinstance(k, str) for k in v)
                and all(_is_array_pytree(x) for x in v.values()))
    if isinstance(v, (list, tuple)):
        return bool(v) and all(_is_array_pytree(x) for x in v)
    return False


def save_stage(stage, path: str, overwrite: bool = True) -> None:
    from .pipeline import PipelineStage  # local import to avoid cycle

    prepare_dir(path, overwrite)
    meta = {
        "class": f"{type(stage).__module__}.{type(stage).__qualname__}",
        "uid": stage.uid,
        "params": _jsonify(stage.simple_param_values()),
        "complexParams": {},
    }
    for name, value in stage.complex_param_values().items():
        entry: dict[str, Any] = {}
        target = os.path.join(path, f"complex_{name}")
        if isinstance(value, PipelineStage):
            entry["kind"] = "stage"
            save_stage(value, target, overwrite=overwrite)
        elif isinstance(value, list) and value and all(isinstance(v, PipelineStage) for v in value):
            entry["kind"] = "stage_list"
            entry["n"] = len(value)
            for i, v in enumerate(value):
                save_stage(v, f"{target}_{i:03d}", overwrite=overwrite)
        elif _is_array_pytree(value):
            entry["kind"] = "pytree"
            save_pytree(value, target)
        else:
            entry["kind"] = "pickle"
            with open(target + ".pkl", "wb") as f:
                pickle.dump(value, f)
        meta["complexParams"][name] = entry
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def _jsonify(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _unjsonify(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


def load_stage(path: str):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    mod_name, _, cls_name = meta["class"].rpartition(".")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    stage = cls.__new__(cls)
    # re-run Params.__init__ machinery without subclass ctor side effects
    from .params import Params

    Params.__init__(stage, uid=meta["uid"])
    stage.set(**_unjsonify(meta["params"]))
    for name, entry in meta.get("complexParams", {}).items():
        target = os.path.join(path, f"complex_{name}")
        if entry["kind"] == "stage":
            value = load_stage(target)
        elif entry["kind"] == "stage_list":
            value = [load_stage(f"{target}_{i:03d}") for i in range(entry["n"])]
        elif entry["kind"] == "pytree":
            value = load_pytree(target)
        else:
            with open(target + ".pkl", "rb") as f:
                value = pickle.load(f)
        stage.set(**{name: value})
    # where the stage was loaded from: an artifact with sidecar trees beside
    # metadata.json (retrieval index shards, published through
    # ``ModelRegistry.publish(extra_tree=...)``) resolves them through it
    stage._artifact_dir = os.path.abspath(path)
    if hasattr(stage, "_post_load"):
        stage._post_load()
    return stage
