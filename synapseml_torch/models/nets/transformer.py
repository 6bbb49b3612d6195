"""Shared transformer building blocks as torch ``nn.Module``s.

Counterpart of ``synapseml_tpu/models/flax_nets/transformer.py``, with the
same numerics on the encoder path:
  * params in ``cfg.param_dtype`` (f32), compute in ``cfg.dtype`` (bf16 by
    default): each dense layer casts its weights to the compute dtype, as
    Flax's ``Dense(dtype=..., param_dtype=...)`` does;
  * LayerNorm / RMSNorm statistics in f32, output in ``cfg.dtype``;
  * exact-erf GELU (``act='gelu'``), the tanh form as ``'gelu_tanh'``;
  * ``attn_impl='einsum'``: scores in the compute dtype divided by
    ``sqrt(D)`` in that dtype, masked with ``finfo(dtype).min`` (a fully
    masked row averages V); ``attn_impl='flash'``: the hand-written kernel
    of :mod:`synapseml_torch.ops.attention` (a fully masked row gives 0).

Mixture-of-experts, rotary embeddings, the decode cache and the
sequence-parallel backends arrive with the LLM and multi-GPU slices; the
config has no fields for them until then.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import flash_attention

__all__ = ["TransformerConfig", "Attention", "MlpBlock", "Block", "Encoder",
           "LayerNorm", "RMSNorm", "dense"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int | None = None  # None -> MHA; < n_heads -> GQA
    mlp_dim: int = 3072
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    causal: bool = False
    norm: str = "layernorm"  # or "rmsnorm"
    # 'pre' (norm before attn/mlp + final encoder norm) or 'post' (norm
    # after each residual add, no final norm — original BERT)
    norm_position: str = "pre"
    gated_mlp: bool = False  # SwiGLU when True
    act: str = "gelu"
    norm_eps: float = 1e-6
    attn_impl: str = "einsum"  # or 'flash' (the CUDA kernel)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


_ACTS = {"gelu": F.gelu,  # the exact erf form HF BERT checkpoints use
         "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu, "silu": F.silu}


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias cast first."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(self.dtype)


def _norm(cfg: TransformerConfig) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.hidden, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
    return LayerNorm(cfg.hidden, cfg.norm_eps, cfg.dtype, cfg.param_dtype)


def _causal_mask(q_len: int, kv_len: int, device) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, None]  # [1,1,Q,KV]


class Attention(nn.Module):
    """Multi-head / grouped-query attention; the score/softmax/value core
    dispatches on ``cfg.attn_impl``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.attn_impl not in ("einsum", "flash"):
            raise ValueError(f"attn_impl must be 'einsum' or 'flash', got {cfg.attn_impl!r}")
        self.cfg = cfg
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        pd = cfg.param_dtype
        self.q = nn.Linear(cfg.hidden, H * D, dtype=pd)
        self.k = nn.Linear(cfg.hidden, KV * D, dtype=pd)
        self.v = nn.Linear(cfg.hidden, KV * D, dtype=pd)
        self.o = nn.Linear(H * D, cfg.hidden, dtype=pd)
        # sqrt(D) rounded to the compute dtype, as the JAX einsum path divides
        # by jnp.sqrt(D).astype(dtype); built on the CPU so that constructing
        # the module on the meta device works
        self._sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32,
                                    device="cpu").to(cfg.dtype).item()

    def _attend(self, q, k, v, mask):
        cfg = self.cfg
        # flash takes padding (kv-position) masks; an arbitrary [.., Q, K]
        # mask takes the einsum path
        mask_is_kv_shaped = (mask is not None and mask.dim() == 4
                             and mask.shape[1] == 1 and mask.shape[2] == 1)
        if cfg.attn_impl == "flash" and (mask is None or mask_is_kv_shaped):
            kv_mask = mask[:, 0, 0, :] if mask_is_kv_shaped else None
            return flash_attention(q, k, v, kv_mask=kv_mask, causal=cfg.causal)

        if cfg.causal:
            causal = _causal_mask(q.shape[1], k.shape[1], q.device)
            mask = causal if mask is None else mask & causal
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / self._sqrt_d
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(cfg.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = dense(self.q, x, cfg.dtype).view(B, T, H, D)
        k = dense(self.k, x, cfg.dtype).view(B, T, KV, D)
        v = dense(self.v, x, cfg.dtype).view(B, T, KV, D)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        out = self._attend(q, k, v, mask)
        return dense(self.o, out.reshape(B, T, H * D), cfg.dtype)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        if cfg.gated_mlp:
            self.gate = nn.Linear(cfg.hidden, cfg.mlp_dim, dtype=pd)
        self.up = nn.Linear(cfg.hidden, cfg.mlp_dim, dtype=pd)
        self.down = nn.Linear(cfg.mlp_dim, cfg.hidden, dtype=pd)

    def forward(self, x):
        cfg = self.cfg
        act = _ACTS[cfg.act]
        if cfg.gated_mlp:
            h = act(dense(self.gate, x, cfg.dtype)) * dense(self.up, x, cfg.dtype)
        else:
            h = act(dense(self.up, x, cfg.dtype))
        return dense(self.down, h, cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.post = cfg.norm_position == "post"
        self.attn = Attention(cfg)
        self.norm1 = _norm(cfg)
        self.mlp = MlpBlock(cfg)
        self.norm2 = _norm(cfg)

    def forward(self, x, mask=None):
        if self.post:
            # original-BERT residual structure: add then norm
            x = self.norm1(x + self.attn(x, mask))
            return self.norm2(x + self.mlp(x))
        x = x + self.attn(self.norm1(x), mask)
        return x + self.mlp(self.norm2(x))


class Encoder(nn.Module):
    """Stack of blocks; pre-norm stacks end with a final norm."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = _norm(cfg) if cfg.norm_position != "post" else None

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x if self.norm is None else self.norm(x)
