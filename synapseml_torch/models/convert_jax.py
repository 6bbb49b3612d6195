"""Carry BERT classifier weights from the JAX package's layout to this one.

:func:`bert_state_dict_from_flax` takes the unboxed Flax param tree of
``synapseml_tpu.models.flax_nets.bert.BertClassifier`` (nested dicts of
numpy arrays, e.g. ``jax.tree.map(np.asarray, nn.unbox(params))``) and
returns the ``state_dict`` of :class:`..nets.bert.BertClassifier` as numpy
arrays. It needs no JAX: only the names and shapes of the tree.

  * ``Dense.kernel [in, out]`` -> ``Linear.weight [out, in]``;
  * ``attn/{q,k,v}.kernel [hidden, H, D]`` -> ``reshape(hidden, H*D).T``,
    bias ``[H, D]`` -> ``[H*D]``;
  * ``attn/o.kernel [H, D, hidden]`` -> ``reshape(H*D, hidden).T``;
  * ``LayerNorm_k`` / ``RMSNorm_k`` ``.scale`` -> ``.weight``; inside a
    block ``_0`` is ``norm1`` and ``_1`` is ``norm2``; at encoder level
    ``_0`` is the final norm of pre-norm stacks;
  * embedding tables keep their shape.

:func:`init_flax_bert_params` makes a seeded random tree in that Flax
layout with numpy alone, so a full-width model can be built on a host
without JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bert_state_dict_from_flax", "init_flax_bert_params"]


def _arr(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a))


def _norm(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _arr(tree["scale"])
    if "bias" in tree:
        out[f"{prefix}.bias"] = _arr(tree["bias"])


def _dense(out: dict, prefix: str, tree: dict, kind: str = "dense") -> None:
    kernel = np.asarray(tree["kernel"])
    if kind == "in_proj":      # [hidden, H, D] -> [H*D, hidden]
        kernel = kernel.reshape(kernel.shape[0], -1)
    elif kind == "out_proj":   # [H, D, hidden] -> [hidden, H*D]
        kernel = kernel.reshape(-1, kernel.shape[-1])
    out[f"{prefix}.weight"] = _arr(kernel.T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _arr(np.asarray(tree["bias"]).reshape(-1))


def _norm_key(tree: dict, k: int) -> dict:
    for name in (f"LayerNorm_{k}", f"RMSNorm_{k}"):
        if name in tree:
            return tree[name]
    raise KeyError(f"no LayerNorm_{k} / RMSNorm_{k} among {sorted(tree)}")


def bert_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """Flax ``BertClassifier`` params -> this package's ``state_dict``."""
    unknown = set(params) - {"embeddings", "encoder", "pooler", "classifier"}
    if unknown:
        raise KeyError(f"not a BertClassifier param tree: unexpected {sorted(unknown)}")
    out: dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    for table in ("word", "position", "segment"):
        out[f"embeddings.{table}.weight"] = _arr(emb[table]["embedding"])
    _norm(out, "embeddings.norm", emb["LayerNorm_0"])
    for name, sub in params["encoder"].items():
        if not name.startswith("layer_"):
            continue
        pre = f"encoder.layers.{int(name[len('layer_'):])}"
        for proj in ("q", "k", "v"):
            _dense(out, f"{pre}.attn.{proj}", sub["attn"][proj], "in_proj")
        _dense(out, f"{pre}.attn.o", sub["attn"]["o"], "out_proj")
        for mlp_name, mlp in sub["mlp"].items():
            _dense(out, f"{pre}.mlp.{mlp_name}", mlp)
        _norm(out, f"{pre}.norm1", _norm_key(sub, 0))
        _norm(out, f"{pre}.norm2", _norm_key(sub, 1))
    if any(k.endswith("Norm_0") for k in params["encoder"]):
        _norm(out, "encoder.norm", _norm_key(params["encoder"], 0))
    _dense(out, "pooler", params["pooler"])
    _dense(out, "classifier", params["classifier"])
    return out


def init_flax_bert_params(cfg, num_classes: int = 2, seed: int = 0) -> dict:
    """Seeded random ``BertClassifier`` params in the Flax layout (numpy
    only): embeddings ~ N(0, 0.02), dense kernels Xavier-uniform, biases 0,
    norm scales 1 — the JAX package's initialisers, drawn from numpy."""
    rng = np.random.default_rng(seed)
    hid, H, KV, D = cfg.hidden, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def xavier(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": xavier((n_in, n_out), n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm():
        tree = {"scale": np.ones(hid, np.float32)}
        if cfg.norm != "rmsnorm":
            tree["bias"] = np.zeros(hid, np.float32)
        return tree

    norm_name = "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"
    tree = {"embeddings": {"word": {"embedding": normal((cfg.vocab_size, hid))},
                           "position": {"embedding": normal((cfg.max_len, hid))},
                           "segment": {"embedding": normal((2, hid))},
                           "LayerNorm_0": {"scale": np.ones(hid, np.float32),
                                           "bias": np.zeros(hid, np.float32)}},
            "encoder": {}}
    for i in range(cfg.n_layers):
        attn = {p: {"kernel": xavier((hid, h, D), hid, h * D),
                    "bias": np.zeros((h, D), np.float32)}
                for p, h in (("q", H), ("k", KV), ("v", KV))}
        attn["o"] = {"kernel": xavier((H, D, hid), H * D, hid),
                     "bias": np.zeros(hid, np.float32)}
        mlp = {"up": dense(hid, cfg.mlp_dim), "down": dense(cfg.mlp_dim, hid)}
        if cfg.gated_mlp:
            mlp["gate"] = dense(hid, cfg.mlp_dim)
        tree["encoder"][f"layer_{i}"] = {"attn": attn, "mlp": mlp,
                                         f"{norm_name}_0": norm(),
                                         f"{norm_name}_1": norm()}
    if cfg.norm_position != "post":
        tree["encoder"][f"{norm_name}_0"] = norm()
    tree["pooler"] = dense(hid, hid)
    tree["classifier"] = dense(hid, num_classes)
    return tree
