"""Carry weights from the JAX package's Flax layouts to this package's modules.

Each ``*_state_dict_from_flax`` takes an unboxed Flax tree (nested dicts of
numpy arrays, e.g. ``jax.tree.map(np.asarray, nn.unbox(params))``) and
returns the ``state_dict`` entries of this package's module as numpy
arrays. They need no JAX: only the names and shapes of the tree.

  * ``Dense.kernel [in, out]`` -> ``Linear.weight [out, in]``;
  * ``attn/{q,k,v}.kernel [hidden, H, D]`` -> ``reshape(hidden, H*D).T``,
    bias ``[H, D]`` -> ``[H*D]``;
  * ``attn/o.kernel [H, D, hidden]`` -> ``reshape(H*D, hidden).T``;
  * ``LayerNorm_k`` / ``RMSNorm_k`` ``.scale`` -> ``.weight``; inside a
    block ``_0`` is ``norm1`` and ``_1`` is ``norm2``; at encoder level
    ``_0`` is the final norm of pre-norm stacks;
  * embedding tables, ``cls`` and ``pos_embed`` keep their shape;
  * ``Conv.kernel [kh, kw, in, out]`` (HWIO) -> ``Conv2d.weight [out, in,
    kh, kw]`` (OIHW);
  * an ``MoEBlock``'s ``router.kernel [hidden, E]`` -> ``mlp.router.weight
    [E, hidden]``; its expert arrays (``w_up``, ``w_gate``, ``w_dn``,
    ``b_up``, ``b_dn``) keep their names and shapes;
  * ``BatchNorm`` ``scale``/``bias`` -> ``weight``/``bias``, and its
    ``batch_stats`` ``mean``/``var`` -> the buffers of the same names; a
    ResNet block ``stage<i>_block<j>`` -> ``blocks.stage<i>_block<j>``.

``init_flax_{bert,vit,resnet}_params`` make seeded random trees in those
Flax layouts with numpy alone, from the JAX modules' initialisers (the same
distributions, not the same bits as ``jax.random``), so a full-width model
can be built on a host without JAX. :func:`init_llama_params` draws the
Llama initialisers straight into a ``LlamaLM`` state_dict with a seeded
``torch.Generator`` on the target device: at 7B a numpy draw on the host
would take about a minute.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["bert_state_dict_from_flax", "init_flax_bert_params", "vit_state_dict_from_flax",
           "init_flax_vit_params", "resnet_state_dict_from_flax", "init_flax_resnet_params",
           "llama_state_dict_from_flax", "init_llama_params"]


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


def _encoder_state(out: dict, prefix: str, encoder: dict) -> None:
    """A Flax ``Encoder`` subtree -> ``{prefix}.layers.<i>...`` entries."""
    for name, sub in encoder.items():
        if not name.startswith("layer_"):
            continue
        pre = f"{prefix}.layers.{int(name[len('layer_'):])}"
        for proj in ("q", "k", "v"):
            _dense(out, f"{pre}.attn.{proj}", sub["attn"][proj], "in_proj")
        _dense(out, f"{pre}.attn.o", sub["attn"]["o"], "out_proj")
        for mlp_name, mlp in sub["mlp"].items():
            if isinstance(mlp, dict):  # a Dense; an MoE block's router too
                _dense(out, f"{pre}.mlp.{mlp_name}", mlp)
            else:  # an MoE block's expert arrays, as they are
                out[f"{pre}.mlp.{mlp_name}"] = _arr(mlp)
        _norm(out, f"{pre}.norm1", _norm_key(sub, 0))
        _norm(out, f"{pre}.norm2", _norm_key(sub, 1))
    if any(k.endswith("Norm_0") for k in encoder):
        _norm(out, f"{prefix}.norm", _norm_key(encoder, 0))


def _conv_kernel(kernel) -> np.ndarray:
    """Flax ``Conv.kernel`` [kh, kw, in, out] (HWIO) -> ``Conv2d.weight``
    [out, in, kh, kw] (OIHW)."""
    return _arr(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


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
    _encoder_state(out, "encoder", params["encoder"])
    _dense(out, "pooler", params["pooler"])
    _dense(out, "classifier", params["classifier"])
    return out


def vit_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """Flax ``ViTClassifier`` params -> :class:`..nets.vit.ViTClassifier`'s
    ``state_dict``: the patch embedding HWIO -> OIHW, ``cls`` and
    ``pos_embed`` as they are."""
    unknown = set(params) - {"patch_embed", "cls", "pos_embed", "encoder", "head"}
    if unknown:
        raise KeyError(f"not a ViTClassifier param tree: unexpected {sorted(unknown)}")
    out = {"patch_embed.weight": _conv_kernel(params["patch_embed"]["kernel"]),
           "patch_embed.bias": _arr(params["patch_embed"]["bias"]),
           "cls": _arr(params["cls"]), "pos_embed": _arr(params["pos_embed"])}
    _encoder_state(out, "encoder", params["encoder"])
    _dense(out, "head", params["head"])
    return out


def llama_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """Flax ``LlamaLM`` params -> :class:`..nets.llama.LlamaLM`'s
    ``state_dict``: ``embed`` (and ``wpe``) tables as they are, the decoder
    as an encoder, ``lm_head`` transposed. The paged modules run the same
    module, so one tree drives both engines."""
    unknown = set(params) - {"embed", "wpe", "decoder", "lm_head"}
    if unknown:
        raise KeyError(f"not a LlamaLM param tree: unexpected {sorted(unknown)}")
    out = {"embed.weight": _arr(params["embed"]["embedding"])}
    if "wpe" in params:
        out["wpe.weight"] = _arr(params["wpe"]["embedding"])
    _encoder_state(out, "decoder", params["decoder"])
    _dense(out, "lm_head", params["lm_head"])
    return out


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "mean", "var": "var"}


def _resnet_prefix(name: str) -> str:
    return f"blocks.{name}" if name.startswith("stage") else name


def resnet_state_dict_from_flax(params: dict | None = None,
                                batch_stats: dict | None = None) -> dict[str, np.ndarray]:
    """Flax ``ResNet`` variables -> :class:`..nets.resnet.ResNet`'s
    ``state_dict`` entries: from ``params`` the parameters (conv kernels HWIO
    -> OIHW, BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, the head),
    from ``batch_stats`` the BatchNorm buffers ``mean``/``var``; either tree
    alone gives only its own entries."""
    out: dict[str, np.ndarray] = {}

    def walk(prefix: str, tree: dict) -> None:
        for name, sub in tree.items():
            if "kernel" in sub and name != "head":  # a convolution
                out[f"{prefix}{name}.weight"] = _conv_kernel(sub["kernel"])
            elif name == "head":
                _dense(out, f"{prefix}head", sub)
            elif set(sub) <= set(_BN_LEAVES):  # a BatchNorm
                for leaf, value in sub.items():
                    out[f"{prefix}{name}.{_BN_LEAVES[leaf]}"] = _arr(value)
            else:  # a block
                walk(f"{_resnet_prefix(name)}.", sub)

    for tree in (params, batch_stats):
        if tree is not None:
            walk("", tree)
    return out


# ---------------------------------------------------------------------------
# the JAX package's initialisers, drawn with numpy
# ---------------------------------------------------------------------------

def _xavier(rng, shape, fan_in, fan_out) -> np.ndarray:
    """``xavier_uniform``: U(-lim, lim), lim = sqrt(6 / (fan_in + fan_out))."""
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, shape).astype(np.float32)


def _lecun_normal(rng, shape, fan_in) -> np.ndarray:
    """``lecun_normal``, Flax's default kernel init: a normal truncated to
    (-2, 2) standard deviations, scaled to variance ``1 / fan_in``."""
    x = rng.standard_normal(shape)
    out = np.abs(x) >= 2
    while out.any():  # redraw the tails
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) >= 2
    stddev = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return (x * stddev).astype(np.float32)


def _flax_encoder(cfg, rng) -> dict:
    """An ``Encoder``'s params: attention and MLP kernels Xavier-uniform,
    biases 0, norm scales 1; an MoE layer's router and expert kernels
    Xavier-uniform too, over the fans Flax gives an ``[E, in, out]`` kernel
    (the expert axis a receptive field: ``E*in``, ``E*out``)."""
    hid, H, KV, D = cfg.hidden, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def dense(n_in, n_out):
        return {"kernel": _xavier(rng, (n_in, n_out), n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def moe():
        E, M = cfg.moe_experts, cfg.mlp_dim
        tree = {"router": {"kernel": _xavier(rng, (hid, E), hid, E)},
                "w_up": _xavier(rng, (E, hid, M), E * hid, E * M),
                "b_up": np.zeros((E, M), np.float32),
                "w_dn": _xavier(rng, (E, M, hid), E * M, E * hid),
                "b_dn": np.zeros((E, hid), np.float32)}
        if cfg.gated_mlp:
            tree["w_gate"] = _xavier(rng, (E, hid, M), E * hid, E * M)
        return tree

    def norm():
        tree = {"scale": np.ones(hid, np.float32)}
        if cfg.norm != "rmsnorm":
            tree["bias"] = np.zeros(hid, np.float32)
        return tree

    norm_name = "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"
    tree = {}
    for i in range(cfg.n_layers):
        attn = {p: {"kernel": _xavier(rng, (hid, h, D), hid, h * D),
                    "bias": np.zeros((h, D), np.float32)}
                for p, h in (("q", H), ("k", KV), ("v", KV))}
        attn["o"] = {"kernel": _xavier(rng, (H, D, hid), H * D, hid),
                     "bias": np.zeros(hid, np.float32)}
        if cfg.moe_experts > 0:
            mlp = moe()
        else:
            mlp = {"up": dense(hid, cfg.mlp_dim), "down": dense(cfg.mlp_dim, hid)}
            if cfg.gated_mlp:
                mlp["gate"] = dense(hid, cfg.mlp_dim)
        tree[f"layer_{i}"] = {"attn": attn, "mlp": mlp, f"{norm_name}_0": norm(),
                              f"{norm_name}_1": norm()}
    if cfg.norm_position != "post":
        tree[f"{norm_name}_0"] = norm()
    return tree


def init_flax_bert_params(cfg, num_classes: int = 2, seed: int = 0) -> dict:
    """Seeded random ``BertClassifier`` params in the Flax layout (numpy
    only): embeddings ~ N(0, 0.02), dense kernels Xavier-uniform, biases 0,
    norm scales 1 — the JAX package's initialisers, drawn from numpy."""
    rng = np.random.default_rng(seed)
    hid = cfg.hidden

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def dense(n_in, n_out):
        return {"kernel": _xavier(rng, (n_in, n_out), n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    tree = {"embeddings": {"word": {"embedding": normal((cfg.vocab_size, hid))},
                           "position": {"embedding": normal((cfg.max_len, hid))},
                           "segment": {"embedding": normal((2, hid))},
                           "LayerNorm_0": {"scale": np.ones(hid, np.float32),
                                           "bias": np.zeros(hid, np.float32)}}}
    tree["encoder"] = _flax_encoder(cfg, rng)
    tree["pooler"] = dense(hid, hid)
    tree["classifier"] = dense(hid, num_classes)
    return tree


def init_flax_vit_params(cfg, num_classes: int = 1000, patch: int = 16,
                         in_channels: int = 3, seed: int = 0) -> dict:
    """Seeded random ``ViTClassifier`` params in the Flax layout (numpy
    only), the JAX module's initialisers: the patch embedding and the head
    Xavier-uniform, ``pos_embed`` ~ N(0, 0.02), ``cls`` and biases 0, the
    encoder as BERT's."""
    rng = np.random.default_rng(seed)
    hid, rf = cfg.hidden, patch * patch
    return {"patch_embed": {"kernel": _xavier(rng, (patch, patch, in_channels, hid),
                                              rf * in_channels, rf * hid),
                            "bias": np.zeros(hid, np.float32)},
            "cls": np.zeros((1, 1, hid), np.float32),
            "pos_embed": rng.standard_normal((1, cfg.max_len, hid), dtype=np.float32)
            * np.float32(0.02),
            "encoder": _flax_encoder(cfg, rng),
            "head": {"kernel": _xavier(rng, (hid, num_classes), hid, num_classes),
                     "bias": np.zeros(num_classes, np.float32)}}


def init_flax_resnet_params(stage_sizes=(3, 4, 6, 3), block: str = "bottleneck",
                            num_classes: int = 1000, width: int = 64, in_channels: int = 3,
                            seed: int = 0) -> dict:
    """Seeded random ``ResNet`` variables in the Flax layout (numpy only):
    ``{"params": ..., "batch_stats": ...}`` with the JAX module's
    initialisers: conv kernels and the head ``lecun_normal``, biases 0,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}

    def conv(k, c_in, c_out):
        return {"kernel": _lecun_normal(rng, (k, k, c_in, c_out), k * k * c_in)}

    def bn(where_p, where_s, name, c):
        where_p[name] = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
        where_s[name] = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    params["stem"] = conv(7, in_channels, width)
    bn(params, stats, "stem_bn", width)
    c = width
    expansion = 4 if block == "bottleneck" else 1
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2 ** i
        for j in range(n_blocks):
            strides = 2 if j == 0 and i > 0 else 1
            bp, bs = {}, {}
            if block == "bottleneck":
                layers = (("conv1", "bn1", 1, c, f), ("conv2", "bn2", 3, f, f),
                          ("conv3", "bn3", 1, f, 4 * f))
            else:
                layers = (("conv1", "bn1", 3, c, f), ("conv2", "bn2", 3, f, f))
            for conv_name, bn_name, k, c_in, c_out in layers:
                bp[conv_name] = conv(k, c_in, c_out)
                bn(bp, bs, bn_name, c_out)
            if c != f * expansion or strides != 1:
                bp["proj"] = conv(1, c, f * expansion)
                bn(bp, bs, "bn_proj", f * expansion)
            params[f"stage{i}_block{j}"], stats[f"stage{i}_block{j}"] = bp, bs
            c = f * expansion
    params["head"] = {"kernel": _lecun_normal(rng, (c, num_classes), c),
                      "bias": np.zeros(num_classes, np.float32)}
    return {"params": params, "batch_stats": stats}


def init_llama_params(cfg, seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """A seeded random :class:`..nets.llama.LlamaLM` ``state_dict`` on
    ``device`` in ``cfg.param_dtype``, with the JAX module's initialisers
    (the distributions, not the bits of ``jax.random``): ``embed``, ``wpe``
    and ``lm_head`` N(0, 0.02); attention and MLP kernels Xavier-uniform
    over their flattened (in, out) fans, as ``_xavier``; an MoE layer's
    router likewise and its expert kernels over Flax's ``(E*in, E*out)``
    fans; biases 0, norm scales 1. Drawn in order from one
    ``torch.Generator(device)`` seeded with ``seed``. ``device`` defaults
    to the card; a host without one must ask for ``"cpu"``."""
    device = resolve_device("init_llama_params", device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pd = cfg.param_dtype
    hid, H, KV, D, mlp = cfg.hidden, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.mlp_dim

    def normal(shape):
        return torch.empty(shape, dtype=pd, device=device).normal_(0.0, 0.02, generator=gen)

    def xavier(n_in, n_out):  # a torch Linear weight [out, in]
        lim = math.sqrt(6.0 / (n_in + n_out))
        return torch.empty((n_out, n_in), dtype=pd, device=device).uniform_(
            -lim, lim, generator=gen)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def experts(E, n_in, n_out):  # an [E, in, out] kernel, the expert axis in the fans
        lim = math.sqrt(6.0 / (E * n_in + E * n_out))
        return torch.empty((E, n_in, n_out), dtype=pd, device=device).uniform_(
            -lim, lim, generator=gen)

    out = {"embed.weight": normal((cfg.vocab_size, hid))}
    if cfg.learned_pos:
        out["wpe.weight"] = normal((cfg.max_len, hid))
    for i in range(cfg.n_layers):
        pre = f"decoder.layers.{i}"
        for proj, heads in (("q", H), ("k", KV), ("v", KV)):
            out[f"{pre}.attn.{proj}.weight"] = xavier(hid, heads * D)
            out[f"{pre}.attn.{proj}.bias"] = zeros(heads * D)
        out[f"{pre}.attn.o.weight"] = xavier(H * D, hid)
        out[f"{pre}.attn.o.bias"] = zeros(hid)
        if cfg.moe_experts > 0:
            E = cfg.moe_experts
            out[f"{pre}.mlp.router.weight"] = xavier(hid, E)
            for name in ("w_gate", "w_up") if cfg.gated_mlp else ("w_up",):
                out[f"{pre}.mlp.{name}"] = experts(E, hid, mlp)
            out[f"{pre}.mlp.w_dn"] = experts(E, mlp, hid)
            out[f"{pre}.mlp.b_up"] = zeros(E, mlp)
            out[f"{pre}.mlp.b_dn"] = zeros(E, hid)
        else:
            names = ("gate", "up") if cfg.gated_mlp else ("up",)
            for name in names:
                out[f"{pre}.mlp.{name}.weight"] = xavier(hid, mlp)
                out[f"{pre}.mlp.{name}.bias"] = zeros(mlp)
            out[f"{pre}.mlp.down.weight"] = xavier(mlp, hid)
            out[f"{pre}.mlp.down.bias"] = zeros(hid)
        out[f"{pre}.norm1.weight"] = torch.ones(hid, dtype=pd, device=device)
        out[f"{pre}.norm2.weight"] = torch.ones(hid, dtype=pd, device=device)
    out["decoder.norm.weight"] = torch.ones(hid, dtype=pd, device=device)
    out["lm_head.weight"] = normal((cfg.vocab_size, hid))
    return out
