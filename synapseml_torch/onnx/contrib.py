"""``com.microsoft`` contrib ops: ONNX Runtime's transformer-fusion opset.

Counterpart of ``synapseml_tpu/onnx/contrib.py``. ORT's graph optimizer
rewrites transformer models into these ops (its ``FusionAttention`` and
``FusionSkipLayerNormalization`` passes emit ``com.microsoft`` nodes), and
BERT and GPT models saved after that optimization ship in this form.

Registered into :data:`~.convert.OP_REGISTRY` by op type (contrib names do
not collide with the stock opset; the converter keys by ``op_type``). Each
op is plain torch, as the reference's is plain ``jnp``: ``Attention`` is two
products and a softmax in f32, masked with -1e30 before the softmax (a fully
masked row averages its values; the flash kernel would give it zeros), so it
does not go through the port's flash kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .convert import OP_REGISTRY, _opt, op

_BEFORE_CONTRIB = frozenset(OP_REGISTRY)

_SQRT_2_OVER_PI = 0.7978845608028654


def _tanh_gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


@op("FastGelu")
def _fast_gelu(ins, attrs):
    x = ins[0]
    if _opt(ins, 1) is not None:
        x = x + ins[1]
    return _tanh_gelu(x)


@op("BiasGelu")
def _bias_gelu(ins, attrs):
    return F.gelu(ins[0] + ins[1])


@op("QuickGelu")
def _quick_gelu(ins, attrs):
    return ins[0] * torch.sigmoid(attrs.get("alpha", 1.702) * ins[0])


def _layer_norm(h, gamma, beta, eps):
    """LayerNorm over the last axis in f32: (out in h's dtype, mean,
    1/std)."""
    hf = h.float()
    mean = torch.mean(hf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(hf - mean), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = (hf - mean) * inv * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(h.dtype), mean, inv


@op("SkipLayerNormalization")
def _skip_layer_norm(ins, attrs):
    """input + skip (+ bias) -> LayerNorm. Outputs (out, mean, inv_std_var,
    input_skip_bias_sum); a node binding fewer takes a prefix."""
    h = ins[0] + ins[1]
    if _opt(ins, 4) is not None:
        h = h + ins[4]
    out, mean, inv = _layer_norm(h, ins[2], _opt(ins, 3), attrs.get("epsilon", 1e-12))
    return out, mean, inv, h


@op("EmbedLayerNormalization")
def _embed_layer_norm(ins, attrs):
    """(input_ids, segment_ids, word_emb, pos_emb, seg_emb, gamma, beta,
    [mask], [position_ids]) -> (output, mask_index, embedding_sum)."""
    input_ids, seg_ids, word_emb, pos_emb = ins[0].long(), ins[1], ins[2], ins[3]
    seg_emb, gamma, beta = _opt(ins, 4), ins[5], _opt(ins, 6)
    mask, pos_ids = _opt(ins, 7), _opt(ins, 8)
    B, S = input_ids.shape
    emb = word_emb[input_ids]
    pos = pos_emb[:S][None] if pos_ids is None else pos_emb[pos_ids.long()]
    emb = emb + pos
    if seg_emb is not None and seg_ids is not None:
        emb = emb + seg_emb[seg_ids.long()]
    out, _, _ = _layer_norm(emb, gamma, beta, attrs.get("epsilon", 1e-12))
    if mask is not None:
        mask_index = torch.sum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    else:
        mask_index = torch.full((B,), S, dtype=torch.int32, device=input_ids.device)
    return out, mask_index, emb


@op("FusedMatMul")
def _fused_matmul(ins, attrs):
    a, b = ins[0], ins[1]
    if attrs.get("transBatchA") or attrs.get("transBatchB"):
        raise NotImplementedError(
            "FusedMatMul transBatchA/transBatchB (batch-dim transposition) is not lowered")
    if attrs.get("transA"):
        a = a.transpose(-1, -2)
    if attrs.get("transB"):
        b = b.transpose(-1, -2)
    out = torch.matmul(a, b)
    alpha = attrs.get("alpha", 1.0)
    return out if alpha == 1.0 else out * alpha


def _key_mask(mask, S: int):
    """The [B, S] keys a query may attend: 1-D right-padded lengths [B] or
    a 2-D raw key mask [B, S] (1 = attend)."""
    if mask.ndim == 1:
        return torch.arange(S, device=mask.device)[None, :] < mask[:, None].to(torch.int32)
    if mask.ndim == 2:
        return mask.bool()
    raise NotImplementedError(
        f"Attention mask_index of rank {mask.ndim} (supported: 1D lengths, 2D raw key mask)")


@op("Attention")
def _attention(ins, attrs):
    """ORT's fused self-attention: (input [B, S, Hin], weights [Hin, 3H],
    bias [3H], [mask], [past], [attention_bias]) -> [B, S, H], the context
    before the output projection.

    Masks: none, [B] key lengths or a raw [B, S] key mask; ``unidirectional``
    adds the causal mask (the GPT fusion form); ``attention_bias`` is added
    to the scores. ``past``/``present`` KV states are refused: batch
    scoring reruns the whole sequence."""
    x, w, b = ins[0], ins[1], ins[2]
    mask, past, attn_bias = _opt(ins, 3), _opt(ins, 4), _opt(ins, 5)
    if past is not None:
        raise NotImplementedError(
            "com.microsoft Attention with a `past` KV state is a decode-loop "
            "form; batch scoring re-runs the full sequence without it")
    if attrs.get("do_rotary"):
        raise NotImplementedError(
            "com.microsoft Attention with do_rotary=1 (the GPT-NeoX fusion "
            "form) is not lowered")
    n_heads = int(attrs["num_heads"])
    if attrs.get("qkv_hidden_sizes"):
        sizes = [int(s) for s in attrs["qkv_hidden_sizes"]]
        if len(set(sizes)) != 1:
            raise NotImplementedError(f"Attention with unequal qkv_hidden_sizes {sizes}")
    B, S, _ = x.shape
    qkv = torch.matmul(x, w) + b                              # [B, S, 3H]
    H = qkv.shape[-1] // 3
    d = H // n_heads
    q, k, v = (t.reshape(B, S, n_heads, d).transpose(1, 2) for t in qkv.split(H, dim=-1))
    scale = attrs.get("scale") or 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~_key_mask(mask, S)[:, None, None, :], -1e30)
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    if attrs.get("unidirectional"):
        causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return out.transpose(1, 2).reshape(B, S, H)


# Gelu is in the stock opset's registry; com.microsoft Gelu is the same
# exact-erf form, so the shared entry covers both domains.
assert "Gelu" in OP_REGISTRY

# exactly the ops this module added to the shared registry
CONTRIB_OPS = frozenset(OP_REGISTRY) - _BEFORE_CONTRIB
