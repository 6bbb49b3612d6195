"""Pretrained-checkpoint ingestion: HF safetensors -> this package's state_dicts.

Counterpart of ``synapseml_tpu/models/convert_hf.py``: the same checkpoint
directories (``config.json`` beside ``model.safetensors`` or a sharded
``model.safetensors.index.json``), the same families (BERT, ViT, ResNet in
torchvision and HF ``microsoft/resnet-*`` naming, Llama with GQA and tied
heads, GPT-2), the same configs and the same seeded new heads. Where the
JAX module maps to Flax trees, each ``*_params_from_hf`` here maps straight
to the ``state_dict`` of this package's module, whose layout is HF's own
(``nn.Linear.weight [out, in]``, ``Conv2d.weight`` OIHW): bitwise what
``convert_jax.*_state_dict_from_flax`` makes of the JAX mapping's tree.

The reader is the package's own: a ``.safetensors`` file is an 8-byte
little-endian header length, a JSON header of ``{name: {dtype, shape,
data_offsets}}``, then the raw little-endian bytes. It maps the file
(``numpy.memmap``, copy-on-write) and returns views of it. The mappings
keep the file's dtype, as the JAX mapping does, and are views wherever the
layout allows (every family but GPT-2, whose Conv1D weights are
transposed, and Mixtral's experts, stacked a layer at a time), so a load
holds little beyond the mapped file: the stages cast to their parameter
dtype as they move each tensor to its device. Every dtype that
``safetensors.numpy.load_file`` reads is read as numpy; ``BF16``, which
numpy has no type for, is read as a ``torch.bfloat16`` view of the same
mapped bytes (not widened on the host; the JAX reader gives the same
values as ``ml_dtypes.bfloat16``), and the maps carry it through as torch
tensors. The float8 types are refused, as ``safetensors.numpy`` refuses
them in a process without ``ml_dtypes``.
Neither ``safetensors`` nor ``transformers`` is imported; the tokenizer of
a checkpoint directory comes through :func:`..tokenizer.from_huggingface`,
which imports ``transformers`` only when called.

A Mixtral directory (``num_local_experts``) maps to dropless ``scatter``
MoE layers, as the JAX mapping does. :func:`shard_pretrained_params`
places a converted ``state_dict`` on a mesh by the rule table.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .nets.bert import BertConfig
from .nets.llama import llama2_7b
from .nets.vit import vit_b16

__all__ = [
    "load_safetensors", "load_checkpoint",
    "is_checkpoint_dir", "resolve_model_source", "legacy_prenorm_fixup",
    "tokenizer_for_checkpoint",
    "bert_config_from_hf", "bert_params_from_hf",
    "vit_config_from_hf", "vit_params_from_hf",
    "llama_config_from_hf", "llama_params_from_hf",
    "gpt2_config_from_hf", "gpt2_params_from_hf",
    "resnet_variables_from_torch", "resnet_arch_from_hf_config",
    "pretrained_text_classifier", "pretrained_encoder",
    "pretrained_vision", "pretrained_causal_lm",
    "shard_pretrained_params", "host_tensor",
]


# ---------------------------------------------------------------------------
# safetensors / checkpoint-dir reading
# ---------------------------------------------------------------------------

# the format's dtype names -> little-endian numpy dtypes: those numpy has
_DTYPES = {"BOOL": np.dtype("?"), "U8": np.dtype("u1"), "I8": np.dtype("i1"),
           "U16": np.dtype("<u2"), "I16": np.dtype("<i2"), "F16": np.dtype("<f2"),
           "U32": np.dtype("<u4"), "I32": np.dtype("<i4"), "F32": np.dtype("<f4"),
           "U64": np.dtype("<u8"), "I64": np.dtype("<i8"), "F64": np.dtype("<f8")}
_NO_NUMPY = {"F8_E4M3": "float8_e4m3fn", "F8_E5M2": "float8_e5m2"}


def _read_safetensors_file(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path!r}: not a safetensors file (shorter than its header length)")
        n = int.from_bytes(head, "little")
        header = json.loads(f.read(n))
    size = os.path.getsize(path)
    start = 8 + n
    header.pop("__metadata__", None)
    # copy-on-write: writable views that never touch the file
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start)
            if size > start else np.zeros(0, np.uint8))
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        kind = info["dtype"]
        if kind not in _DTYPES and kind != "BF16":
            raise TypeError(f"{path!r}: tensor {name!r} is {kind}, which numpy has no "
                            "type for (safetensors.numpy refuses it too: data type "
                            f"{_NO_NUMPY.get(kind, kind)!r} not understood)")
        # BF16: its bits as int16, viewed as torch.bfloat16 below
        dtype, shape = _DTYPES.get(kind, np.dtype("<i2")), tuple(info["shape"])
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= size - start or \
                end - begin != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path!r}: tensor {name!r} has data_offsets {[begin, end]} "
                             f"that do not fit its {kind} shape {list(shape)}")
        arr = data[begin:end].view(dtype).reshape(shape)
        out[name] = torch.from_numpy(arr).view(torch.bfloat16) if kind == "BF16" else arr
    return out


def host_tensor(value) -> torch.Tensor:
    """A state_dict value as a tensor: a tensor (a BF16 checkpoint's) as it
    is, an array without a copy."""
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def load_safetensors(path: str) -> dict:
    """Read one ``.safetensors`` file (or a sharded ``*.index.json``) into
    a flat ``{key: np.ndarray}`` state dict of views of the mapped files
    (``torch.bfloat16`` tensors for BF16)."""
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        base = os.path.dirname(path)
        out: dict[str, np.ndarray] = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(load_safetensors(os.path.join(base, shard)))
        return out
    return _read_safetensors_file(path)


def load_checkpoint(ckpt_dir: str) -> tuple[dict, dict[str, np.ndarray]]:
    """(config.json dict, state dict) from an HF-format checkpoint directory."""
    cfg_path = os.path.join(ckpt_dir, "config.json")
    config: dict = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    for name in ("model.safetensors", "model.safetensors.index.json"):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            return config, load_safetensors(p)
    raise FileNotFoundError(
        f"no model.safetensors[.index.json] in {ckpt_dir!r} "
        f"(found: {sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else 'missing dir'})")


# ---------------------------------------------------------------------------
# checkpoint-dir helpers shared by the four pretrained stages
# ---------------------------------------------------------------------------

def is_checkpoint_dir(name) -> bool:
    """True when ``name`` points at a local HF-format checkpoint directory."""
    return isinstance(name, (str, os.PathLike)) and os.path.isdir(str(name))


def resolve_model_source(name, presets: dict, tokenizer_spec, loader,
                         preset_kwargs: dict | None = None):
    """Checkpoint-dir-vs-preset dispatch of the pretrained transformer
    stages (HuggingFaceCausalLM, HuggingFaceSentenceEmbedder):
    ``(cfg, pretrained state_dict or None, tokenizer)``."""
    from .tokenizer import resolve_tokenizer

    if name in presets:  # a preset wins over a same-named local directory
        tok = resolve_tokenizer(tokenizer_spec)
        cfg = presets[name](vocab_size=tok.vocab_size, **(preset_kwargs or {}))
        return cfg, None, tok
    if is_checkpoint_dir(name):
        cfg, params = loader(str(name))
        tok = tokenizer_for_checkpoint(tokenizer_spec, str(name), cfg.vocab_size)
        return cfg, params, tok
    raise ValueError(f"unknown model_name {name!r}; presets: {sorted(presets)} "
                     f"or a local HF checkpoint dir")


def legacy_prenorm_fixup(cfg, state_dict):
    """Saved artifacts from before the BERT post-norm change carry pre-norm
    param layouts (an encoder-level final norm) with no arch_config; rebuild
    the architecture they were trained as instead of silently mis-evaluating."""
    if cfg.norm_position == "post" and "encoder.norm.weight" in (state_dict or {}):
        return dataclasses.replace(cfg, norm_position="pre", norm_eps=1e-6,
                                   act="gelu_tanh")
    return cfg


# the files a saved transformers tokenizer leaves in its directory
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.txt", "vocab.json",
                    "tokenizer.model", "spiece.model", "sentencepiece.bpe.model")


def tokenizer_for_checkpoint(spec, ckpt_dir: str, model_vocab: int):
    """Resolve the tokenizer for a pretrained checkpoint.

    ``spec`` wins when given; otherwise try the checkpoint dir's own tokenizer
    files. A directory without any is refused before ``transformers`` is
    asked (transformers 5 builds an empty-vocabulary tokenizer from
    ``config.json`` alone, which maps every word to its unknown id). Always
    guard the resolved vocab against the checkpoint's embedding table: an
    oversized id would index past it."""
    from .tokenizer import resolve_tokenizer

    if spec is not None:
        tok = resolve_tokenizer(spec)
    else:
        try:
            if not any(os.path.exists(os.path.join(ckpt_dir, f)) for f in _TOKENIZER_FILES):
                raise ValueError(f"none of {list(_TOKENIZER_FILES)} in {ckpt_dir!r}")
            tok = resolve_tokenizer(str(ckpt_dir))
        except ValueError as e:
            raise ValueError(
                f"checkpoint dir {ckpt_dir!r} has no loadable tokenizer files; "
                f"pass tokenizer= explicitly (e.g. HashingTokenizer("
                f"vocab_size={model_vocab})) or an HF tokenizer name") from e
    if tok.vocab_size > model_vocab:
        raise ValueError(
            f"tokenizer vocab ({tok.vocab_size}) exceeds the checkpoint's "
            f"embedding table ({model_vocab}); ids would be silently clamped")
    return tok


# ---------------------------------------------------------------------------
# shared small helpers
# ---------------------------------------------------------------------------

def _zeros(shape: tuple, like):
    """Zeros of ``like``'s dtype and kind (a BF16 tensor or an array)."""
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=like.dtype)
    return np.zeros(shape, like.dtype)


def _transposed(w):
    """A contiguous copy of the 2-d ``w`` transposed."""
    if isinstance(w, torch.Tensor):
        return w.t().contiguous()
    return np.ascontiguousarray(w.T)


def _split(w, n: int, axis: int) -> list:
    if isinstance(w, torch.Tensor):
        return list(torch.chunk(w, n, dim=axis))
    return np.split(w, n, axis=axis)


def _stack_transposed(ws: list):
    """``[len(ws), in, out]`` from ``[out, in]`` Linear weights: one copy."""
    if isinstance(ws[0], torch.Tensor):
        return torch.stack([w.t() for w in ws])
    return np.stack([w.T for w in ws])


def _linear(out: dict, dst: str, sd: dict, src: str, bias: bool = True) -> None:
    """A torch Linear ``src`` -> ``dst`` as it is (both ``[out, in]``); a
    missing bias is zeros when ``bias``, as the JAX mapping's zero biases."""
    w = sd[f"{src}.weight"]
    out[f"{dst}.weight"] = w
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]
    elif bias:
        out[f"{dst}.bias"] = _zeros((w.shape[0],), w)


def _norm(out: dict, dst: str, sd: dict, src: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if bias:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _strip_prefix(sd: dict, *candidates: str) -> dict:
    """Strip a known top-level prefix (e.g. 'bert.') if present. Non-prefixed
    keys (heads like 'classifier.weight') are kept; a stripped key wins on
    collision with a bare key of the same name."""
    for pref in candidates:
        if any(k.startswith(pref) for k in sd):
            return {k: v for k, v in sd.items() if not k.startswith(pref)} | \
                   {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}
    return sd


def _new_head(out: dict, dst: str, n_in: int, n_out: int, seed: int) -> None:
    """A seeded head as the JAX mapping draws it: a ``[in, out]`` kernel
    N(0, 0.02) from ``default_rng(seed)``, stored transposed; bias 0."""
    kernel = np.random.default_rng(seed).normal(0, 0.02, (n_in, n_out)).astype(np.float32)
    out[f"{dst}.weight"] = np.ascontiguousarray(kernel.T)
    out[f"{dst}.bias"] = np.zeros(n_out, np.float32)


def _n_layers(body: dict, prefix: str, at: int) -> int:
    return 1 + max(int(k.split(".")[at]) for k in body if k.startswith(prefix))


def _act(name: str) -> str:
    return {"gelu": "gelu", "gelu_new": "gelu_tanh",
            "gelu_pytorch_tanh": "gelu_tanh"}.get(name, name)


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def bert_config_from_hf(config: dict, **overrides):
    """HF bert config.json -> TransformerConfig (post-norm, exact gelu)."""
    kw = dict(
        vocab_size=config.get("vocab_size", 30522),
        hidden=config.get("hidden_size", 768),
        n_layers=config.get("num_hidden_layers", 12),
        n_heads=config.get("num_attention_heads", 12),
        mlp_dim=config.get("intermediate_size", 3072),
        max_len=config.get("max_position_embeddings", 512),
        norm_eps=config.get("layer_norm_eps", 1e-12),
        act=_act(config.get("hidden_act", "gelu")),
    )
    kw.update(overrides)
    return BertConfig(**kw)


def bert_params_from_hf(sd: dict[str, np.ndarray], num_classes: int | None = None,
                        seed: int = 0, n_heads: int | None = None) -> dict[str, np.ndarray]:
    """HF BertModel / BertForSequenceClassification state dict -> this
    package's ``BertClassifier`` state_dict.

    When the checkpoint has no classifier head (plain BertModel) and
    ``num_classes`` is given, the pooler (``default_rng(seed)``) and the head
    (``seed + 1``) are seeded as the JAX mapping seeds them. ``n_heads`` is
    the JAX signature's; the flat layout needs no head split."""
    body = _strip_prefix(sd, "bert.")
    n_layers = _n_layers(body, "encoder.layer.", 2)
    hidden = body["embeddings.word_embeddings.weight"].shape[1]
    out: dict[str, np.ndarray] = {}
    for dst, src in (("word", "word"), ("position", "position"), ("segment", "token_type")):
        out[f"embeddings.{dst}.weight"] = body[f"embeddings.{src}_embeddings.weight"]
    _norm(out, "embeddings.norm", body, "embeddings.LayerNorm")
    for i in range(n_layers):
        p, q = f"encoder.layer.{i}", f"encoder.layers.{i}"
        for proj, name in (("q", "query"), ("k", "key"), ("v", "value")):
            _linear(out, f"{q}.attn.{proj}", body, f"{p}.attention.self.{name}")
        _linear(out, f"{q}.attn.o", body, f"{p}.attention.output.dense")
        _linear(out, f"{q}.mlp.up", body, f"{p}.intermediate.dense", bias=False)
        _linear(out, f"{q}.mlp.down", body, f"{p}.output.dense", bias=False)
        _norm(out, f"{q}.norm1", body, f"{p}.attention.output.LayerNorm")
        _norm(out, f"{q}.norm2", body, f"{p}.output.LayerNorm")
    if "pooler.dense.weight" in body:
        _linear(out, "pooler", body, "pooler.dense", bias=False)
    if "classifier.weight" in sd:
        _linear(out, "classifier", sd, "classifier", bias=False)
    if num_classes is not None:
        if "pooler.weight" not in out:
            _new_head(out, "pooler", hidden, hidden, seed)
        if out.get("classifier.weight", np.zeros((0, 0))).shape[0] != num_classes:
            _new_head(out, "classifier", hidden, num_classes, seed + 1)
    return out


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def vit_config_from_hf(config: dict, **overrides):
    image, patch = config.get("image_size", 224), config.get("patch_size", 16)
    kw = dict(
        hidden=config.get("hidden_size", 768),
        n_layers=config.get("num_hidden_layers", 12),
        n_heads=config.get("num_attention_heads", 12),
        mlp_dim=config.get("intermediate_size", 3072),
        max_len=1 + (image // patch) ** 2,
        norm_eps=config.get("layer_norm_eps", 1e-12),
        act=_act(config.get("hidden_act", "gelu")),
    )
    kw.update(overrides)
    return vit_b16(**kw)


def vit_params_from_hf(sd: dict[str, np.ndarray], num_classes: int | None = None,
                       seed: int = 0, n_heads: int | None = None) -> dict[str, np.ndarray]:
    """HF ViTModel / ViTForImageClassification -> ``ViTClassifier``'s
    state_dict: the patch projection (OIHW, as torch stores it), ``cls``,
    ``pos_embed``, pre-norm blocks and the final norm; a missing or
    mis-sized head is seeded from ``default_rng(seed)``."""
    body = _strip_prefix(sd, "vit.")
    n_layers = _n_layers(body, "encoder.layer.", 2)
    hidden = body["embeddings.cls_token"].shape[-1]
    out = {"cls": body["embeddings.cls_token"],
           "pos_embed": body["embeddings.position_embeddings"]}
    _linear(out, "patch_embed", body, "embeddings.patch_embeddings.projection")
    for i in range(n_layers):
        p, q = f"encoder.layer.{i}", f"encoder.layers.{i}"
        for proj, name in (("q", "query"), ("k", "key"), ("v", "value")):
            _linear(out, f"{q}.attn.{proj}", body, f"{p}.attention.attention.{name}")
        _linear(out, f"{q}.attn.o", body, f"{p}.attention.output.dense")
        _linear(out, f"{q}.mlp.up", body, f"{p}.intermediate.dense", bias=False)
        _linear(out, f"{q}.mlp.down", body, f"{p}.output.dense", bias=False)
        _norm(out, f"{q}.norm1", body, f"{p}.layernorm_before")
        _norm(out, f"{q}.norm2", body, f"{p}.layernorm_after")
    _norm(out, "encoder.norm", body, "layernorm")
    if "classifier.weight" in sd:
        _linear(out, "head", sd, "classifier", bias=False)
    if num_classes is not None and \
            out.get("head.weight", np.zeros((0, 0))).shape[0] != num_classes:
        _new_head(out, "head", hidden, num_classes, seed)
    return out


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------

def llama_config_from_hf(config: dict, **overrides):
    """HF llama / mistral / mixtral config.json -> TransformerConfig. A
    Mixtral config (``num_local_experts``) gets MoE layers routed as HF
    routes them: dropless, so ``cf = E / k`` makes ``C = S`` (a token's k
    choices are distinct experts), through the ``scatter`` dispatch (the
    einsum layout's ``[S, E, C]`` tensors are O(S^2 E) at ``C = S``)."""
    kw = dict(
        vocab_size=config.get("vocab_size", 32000),
        hidden=config.get("hidden_size", 4096),
        n_layers=config.get("num_hidden_layers", 32),
        n_heads=config.get("num_attention_heads", 32),
        n_kv_heads=config.get("num_key_value_heads", config.get("num_attention_heads", 32)),
        mlp_dim=config.get("intermediate_size", 11008),
        max_len=config.get("max_position_embeddings", 4096),
        norm_eps=config.get("rms_norm_eps", 1e-5),
        rope_theta=config.get("rope_theta", 10000.0),
    )
    if config.get("num_local_experts"):  # Mixtral-family sparse-MoE decoder
        E = int(config["num_local_experts"])
        k = int(config.get("num_experts_per_tok", 2))
        kw.update(moe_experts=E, moe_top_k=k, moe_capacity_factor=float(E) / k,
                  moe_dispatch="scatter")
    kw.update(overrides)
    return llama2_7b(**kw)


def llama_params_from_hf(sd: dict[str, np.ndarray],
                         n_heads: int | None = None) -> dict[str, np.ndarray]:
    """HF LlamaForCausalLM / MixtralForCausalLM (or the bare models) ->
    ``LlamaLM``'s state_dict.

    GQA needs nothing here (k/v keep their ``[KV * D, hidden]`` rows); a
    missing ``lm_head`` is the tied ``embed_tokens``; missing biases are
    zeros, as the JAX mapping's. A Mixtral layer's ``block_sparse_moe``:
    the router ``gate [E, H]`` as it is, each kind of expert weight
    (``w1`` the SwiGLU gate, ``w3`` up, ``w2`` down) stacked over the
    experts and transposed into ``[E, in, out]`` (one copy a layer, in the
    file's dtype), expert biases zero."""
    body = _strip_prefix(sd, "model.")
    n_layers = _n_layers(body, "layers.", 1)
    embed = body["embed_tokens.weight"]
    out = {"embed.weight": embed}
    for i in range(n_layers):
        p, q = f"layers.{i}", f"decoder.layers.{i}"
        for proj in ("q", "k", "v", "o"):
            _linear(out, f"{q}.attn.{proj}", body, f"{p}.self_attn.{proj}_proj")
        router = f"{p}.block_sparse_moe.gate.weight"
        if router in body:
            ex = f"{p}.block_sparse_moe.experts"
            E = sum(1 for k in body if k.startswith(f"{ex}.") and k.endswith(".w1.weight"))
            out[f"{q}.mlp.router.weight"] = body[router]
            for dst, src in (("w_gate", "w1"), ("w_up", "w3"), ("w_dn", "w2")):
                out[f"{q}.mlp.{dst}"] = _stack_transposed(
                    [body[f"{ex}.{e}.{src}.weight"] for e in range(E)])
            w_up, w_dn = out[f"{q}.mlp.w_up"], out[f"{q}.mlp.w_dn"]
            out[f"{q}.mlp.b_up"] = _zeros((E, w_up.shape[2]), w_up)
            out[f"{q}.mlp.b_dn"] = _zeros((E, w_dn.shape[2]), w_dn)
        else:
            for proj in ("gate", "up", "down"):
                _linear(out, f"{q}.mlp.{proj}", body, f"{p}.mlp.{proj}_proj")
        _norm(out, f"{q}.norm1", body, f"{p}.input_layernorm", bias=False)
        _norm(out, f"{q}.norm2", body, f"{p}.post_attention_layernorm", bias=False)
    _norm(out, "decoder.norm", body, "norm", bias=False)
    out["lm_head.weight"] = sd["lm_head.weight"] if "lm_head.weight" in sd \
        else out["embed.weight"]
    return out


def gpt2_config_from_hf(config: dict, **overrides):
    """HF GPT-2 config -> the generic causal-LM TransformerConfig: LayerNorm
    pre-norm with biases, tanh-GELU MLP, learned absolute positions, no
    RoPE; ``LlamaLM`` runs it unchanged."""
    kw = dict(
        vocab_size=config.get("vocab_size", 50257),
        hidden=config.get("n_embd", 768),
        n_layers=config.get("n_layer", 12),
        n_heads=config.get("n_head", 12),
        n_kv_heads=config.get("n_head", 12),
        mlp_dim=config.get("n_inner") or 4 * config.get("n_embd", 768),
        max_len=config.get("n_positions", config.get("n_ctx", 1024)),
        norm_eps=config.get("layer_norm_epsilon", 1e-5),
    )
    act_map = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
               "gelu": "gelu", "relu": "relu", "silu": "silu", "swish": "silu"}
    hf_act = config.get("activation_function", "gelu_new")
    if hf_act not in act_map:
        raise NotImplementedError(f"GPT-2 activation_function={hf_act!r} is not supported")
    for flag in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        if config.get(flag):
            raise NotImplementedError(
                f"GPT-2 {flag}=true changes attention math; this mapping "
                "covers the standard-attention family only")
    kw.update(norm="layernorm", act=act_map[hf_act], gated_mlp=False,
              use_rope=False, learned_pos=True)
    kw.update(overrides)
    return llama2_7b(**kw)


def gpt2_params_from_hf(sd: dict[str, np.ndarray], n_heads: int) -> dict[str, np.ndarray]:
    """HF GPT2LMHeadModel (or bare GPT2Model) -> ``LlamaLM``'s state_dict.

    GPT-2's Conv1D weights are stored ``[in, out]``: each is transposed into
    a Linear weight; ``c_attn`` splits into q, k and v; the LM head is tied
    to ``wte`` unless the file has its own."""
    body = _strip_prefix(sd, "transformer.")
    n_layers = _n_layers(body, "h.", 1)
    out = {"embed.weight": body["wte.weight"], "wpe.weight": body["wpe.weight"]}

    def conv1d(dst, w, b):
        out[f"{dst}.weight"] = _transposed(w)
        out[f"{dst}.bias"] = b

    for i in range(n_layers):
        p, q = f"h.{i}", f"decoder.layers.{i}"
        w = body[f"{p}.attn.c_attn.weight"]  # [H, 3H]
        b = body[f"{p}.attn.c_attn.bias"]
        for proj, wi, bi in zip("qkv", _split(w, 3, 1), _split(b, 3, 0)):
            conv1d(f"{q}.attn.{proj}", wi, bi)
        conv1d(f"{q}.attn.o", body[f"{p}.attn.c_proj.weight"], body[f"{p}.attn.c_proj.bias"])
        conv1d(f"{q}.mlp.up", body[f"{p}.mlp.c_fc.weight"], body[f"{p}.mlp.c_fc.bias"])
        conv1d(f"{q}.mlp.down", body[f"{p}.mlp.c_proj.weight"], body[f"{p}.mlp.c_proj.bias"])
        _norm(out, f"{q}.norm1", body, f"{p}.ln_1")
        _norm(out, f"{q}.norm2", body, f"{p}.ln_2")
    _norm(out, "decoder.norm", body, "ln_f")
    out["lm_head.weight"] = sd["lm_head.weight"] if "lm_head.weight" in sd \
        else out["embed.weight"]
    return out


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

def _hf_resnet_to_torchvision_keys(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Translate HF ``microsoft/resnet-*`` keys to torchvision naming.

    HF layout (default ``downsample_in_bottleneck=False`` matches torchvision
    v1.5 math, stride on the 3x3): ``resnet.embedder.embedder.convolution`` ->
    conv1, ``resnet.encoder.stages.{s}.layers.{j}.layer.{k}.{convolution,
    normalization}`` -> layer{s+1}.{j}.conv{k+1}/bn{k+1}, ``shortcut`` ->
    downsample, ``classifier.1`` -> fc."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.removeprefix("resnet.")
        if k.startswith("embedder.embedder."):
            rest = k.split("embedder.embedder.", 1)[1]
            if rest.startswith("convolution."):
                out["conv1." + rest.split(".", 1)[1]] = v
            else:  # normalization.*
                out["bn1." + rest.split(".", 1)[1]] = v
        elif k.startswith("encoder.stages."):
            parts = k.split(".")
            s, j = int(parts[2]), int(parts[4])
            rest = parts[5:]
            if rest[0] == "layer":  # layer.{k}.convolution/normalization
                kk = int(rest[1])
                mod = "conv" if rest[2] == "convolution" else "bn"
                out[f"layer{s + 1}.{j}.{mod}{kk + 1}.{'.'.join(rest[3:])}"] = v
            elif rest[0] == "shortcut":
                mod = "0" if rest[1] == "convolution" else "1"
                out[f"layer{s + 1}.{j}.downsample.{mod}.{'.'.join(rest[2:])}"] = v
        elif k.startswith("classifier."):
            out["fc." + k.split(".", 2)[2]] = v
        else:
            out[k] = v
    return out


def _bn(params: dict, stats: dict, dst: str, sd: dict, src: str) -> None:
    _norm(params, dst, sd, src)
    stats[f"{dst}.mean"] = sd[f"{src}.running_mean"]
    stats[f"{dst}.var"] = sd[f"{src}.running_var"]


def resnet_variables_from_torch(sd: dict[str, np.ndarray]) -> dict:
    """torchvision-style ResNet state dict (HF naming too) ->
    ``{"params": ..., "batch_stats": ...}``: the parameters and the
    BatchNorm buffers of :class:`.nets.resnet.ResNet`'s state_dict (convs
    OIHW as torch stores them, ``running_mean``/``running_var`` as the
    buffers ``mean``/``var``)."""
    if any(k.startswith(("resnet.", "embedder.", "encoder.stages.")) for k in sd):
        sd = _hf_resnet_to_torchvision_keys(sd)
    # convolutions carry no bias (the JAX mapping's converted tree keeps none)
    params: dict[str, np.ndarray] = {"stem.weight": sd["conv1.weight"]}
    stats: dict[str, np.ndarray] = {}
    _bn(params, stats, "stem_bn", sd, "bn1")
    for s in sorted({int(k[5]) for k in sd if k.startswith("layer")}):
        for j in sorted({int(k.split(".")[1]) for k in sd if k.startswith(f"layer{s}.")}):
            base, dst = f"layer{s}.{j}", f"blocks.stage{s - 1}_block{j}"
            for c in sorted({k.split(".")[2] for k in sd if k.startswith(f"{base}.conv")}):
                n = c[-1]
                params[f"{dst}.conv{n}.weight"] = sd[f"{base}.conv{n}.weight"]
                _bn(params, stats, f"{dst}.bn{n}", sd, f"{base}.bn{n}")
            if f"{base}.downsample.0.weight" in sd:
                params[f"{dst}.proj.weight"] = sd[f"{base}.downsample.0.weight"]
                _bn(params, stats, f"{dst}.bn_proj", sd, f"{base}.downsample.1")
    if "fc.weight" in sd:
        _linear(params, "head", sd, "fc", bias=False)
    return {"params": params, "batch_stats": stats}


def resnet_arch_from_hf_config(config: dict) -> dict:
    """HF resnet config.json -> ``ResNet(...)`` constructor kwargs."""
    depths = config.get("depths", [3, 4, 6, 3])
    layer_type = config.get("layer_type", "bottleneck")
    return {"stage_sizes": tuple(depths),
            "block": "bottleneck" if layer_type == "bottleneck" else "basic",
            "width": config.get("embedding_size", 64)}


# ---------------------------------------------------------------------------
# high-level checkpoint-directory entry points
# ---------------------------------------------------------------------------

def pretrained_text_classifier(ckpt_dir: str, num_classes: int, seed: int = 0,
                               **cfg_overrides):
    """(TransformerConfig, state_dict) for ``BertClassifier`` from a local HF dir."""
    config, sd = load_checkpoint(ckpt_dir)
    cfg = bert_config_from_hf(config, **cfg_overrides)
    return cfg, bert_params_from_hf(sd, num_classes=num_classes, seed=seed,
                                    n_heads=cfg.n_heads)


def pretrained_encoder(ckpt_dir: str, **cfg_overrides):
    """(TransformerConfig, state_dict) of the headless BERT encoder
    (the HuggingFaceSentenceEmbedder backbone): embeddings and encoder only."""
    config, sd = load_checkpoint(ckpt_dir)
    cfg = bert_config_from_hf(config, **cfg_overrides)
    params = bert_params_from_hf(sd, n_heads=cfg.n_heads)
    return cfg, {k: v for k, v in params.items()
                 if not k.startswith(("pooler.", "classifier."))}


def pretrained_vision(ckpt_dir: str, num_classes: int | None = None, seed: int = 0,
                      **cfg_overrides):
    """(kind, info, variables) for vision checkpoints: ``("vit", {"cfg",
    "patch"}, {"params"})`` or ``("resnet", arch_kwargs, {"params",
    "batch_stats"})``, each a state_dict of this package's module."""
    config, sd = load_checkpoint(ckpt_dir)
    mt = config.get("model_type", "")
    if mt == "vit" or any(k.startswith(("vit.", "embeddings.cls_token")) for k in sd):
        cfg = vit_config_from_hf(config, **cfg_overrides)
        info = {"cfg": cfg, "patch": config.get("patch_size", 16)}
        return "vit", info, {"params": vit_params_from_hf(
            sd, num_classes=num_classes, seed=seed, n_heads=cfg.n_heads)}
    if mt == "resnet" or any("resnet" in k or k.startswith("layer1.") for k in sd):
        arch = resnet_arch_from_hf_config(config)
        variables = resnet_variables_from_torch(sd)
        params = variables["params"]
        if num_classes is not None:
            head = params.get("head.weight")
            if head is None or head.shape[0] != num_classes:
                if head is not None:
                    feat = head.shape[1]
                else:  # final stage width: width * 2^(stages-1) * expansion
                    expansion = 4 if arch["block"] == "bottleneck" else 1
                    feat = arch["width"] * (2 ** (len(arch["stage_sizes"]) - 1)) * expansion
                _new_head(params, "head", feat, num_classes, seed)
        return "resnet", arch, variables
    raise ValueError(f"unrecognized vision checkpoint (model_type={mt!r})")


def pretrained_causal_lm(ckpt_dir: str, **cfg_overrides):
    """(TransformerConfig, state_dict) for ``LlamaLM`` from a local HF dir.

    Dispatches on ``config.json``'s ``model_type``: llama and mistral take
    the Llama mapping (Mixtral's MoE layers included), ``gpt2`` the
    learned-position LayerNorm one."""
    config, sd = load_checkpoint(ckpt_dir)
    if config.get("model_type") == "gpt2":
        cfg = gpt2_config_from_hf(config, **cfg_overrides)
        return cfg, gpt2_params_from_hf(sd, n_heads=cfg.n_heads)
    cfg = llama_config_from_hf(config, **cfg_overrides)
    return cfg, llama_params_from_hf(sd, n_heads=cfg.n_heads)


def shard_pretrained_params(params, mesh_config, partition_rules=None):
    """Place a converted ``state_dict`` on a mesh of the process group by the
    declarative rule table (``parallel.partition``): no module init, any
    tree this module emits. Returns ``(mesh_ctx, placed_params)``, each
    leaf a ``DTensor`` with its table placement (the tensor itself in a
    world of one process without a process group); ``partition_rules``
    defaults to the Llama table (which covers the GPT-2 map's names)."""
    from ..parallel.mesh import create_mesh
    from ..parallel.partition import default_llama_rules, shard_tree

    mesh_ctx = create_mesh(mesh_config)
    rules = (partition_rules if partition_rules is not None
             else default_llama_rules(mesh=mesh_ctx.config))
    return mesh_ctx, shard_tree(params, mesh_ctx, rules)
