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

The decoder side of the JAX module (the Llama family):
  * rotary embeddings (``use_rope``, ``rope_theta``) in the split-half form,
    computed against f32 tables and cast back to the input's dtype, as
    JAX's type promotion does; ``learned_pos`` (GPT-2 absolute positions)
    is read by the LM wrapper;
  * the decode cache: explicit state, a :class:`KVCache` (one K and one V
    tensor a layer and an index) passed in and advanced, not hidden module
    state. Its tensors are head-major ``[B, KV, max_len, D]`` so that the
    decode products read them in place; a step attends over the whole
    ``max_len`` under the offset causal mask, as the JAX cache does.

Mixture-of-experts (``moe_experts > 0``): :class:`MoEBlock`, the switch
MLP of the JAX module (``:314-462`` there), with its ``einsum`` and
``scatter`` dispatches, capacity and drop order, f32 router and load-balance
aux loss; see its docstring for where the port fixes an order the reference
leaves free. The sequence-parallel backends arrive with the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import flash_attention

__all__ = ["TransformerConfig", "Attention", "MlpBlock", "MoEBlock", "Block", "Encoder",
           "LayerNorm", "RMSNorm", "dense", "KVCache", "rope_frequencies",
           "rope_tables", "apply_rope", "make_causal_mask",
           "grouped_attention"]


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
    # 'einsum', 'flash' (the CUDA kernel), or 'ring' / 'ulysses': sequence
    # parallelism over `seq_axis` of the current mesh (flash without one)
    attn_impl: str = "einsum"
    seq_axis: str = "seq"
    use_rope: bool = False
    rope_theta: float = 10000.0
    # learned absolute position embeddings added by the LM wrapper (GPT-2
    # family); RoPE models leave this False
    learned_pos: bool = False
    # mixture-of-experts MLP (switch routing): 0 = the dense MlpBlock
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    # 'einsum': [S, E, C] one-hot dispatch/combine (right for small C);
    # 'scatter': assignments sorted by expert into [E, C, H] buffers (the
    # only feasible layout at a dropless C = S, e.g. Mixtral)
    moe_dispatch: str = "einsum"

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
        # x * rsqrt(mean(x^2) + eps) * scale in f32, as the Flax module
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(),
                          self.eps).to(self.dtype)


def _norm(cfg: TransformerConfig) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.hidden, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
    return LayerNorm(cfg.hidden, cfg.norm_eps, cfg.dtype, cfg.param_dtype)


def make_causal_mask(q_len: int, kv_len: int, offset: int = 0, device=None) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, None]  # [1,1,Q,KV]


def rope_frequencies(head_dim: int, max_len: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv)
    return np.cos(freqs), np.sin(freqs)


@functools.lru_cache(maxsize=16)
def rope_tables(head_dim: int, max_len: int, theta: float, device: str):
    """The f32 cos and sin tables of :func:`rope_frequencies`, each repeated
    to the full head dim, ``[max_len, D]`` on ``device``."""
    cos, sin = rope_frequencies(head_dim, max_len, theta)
    return tuple(torch.from_numpy(np.concatenate([t, t], axis=-1)).to(device)
                 for t in (cos, sin))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] absolute positions; ``cos``,
    ``sin``: :func:`rope_tables`. The split-half form ``[x1 c - x2 s, x2 c +
    x1 s]``, written ``x * c + [-x2, x1] * s`` over the full-width tables
    (the same arithmetic: the negation is exact). The products run in f32
    (the tables' dtype) and the result is cast back to x's."""
    c = cos[positions][:, :, None, :]  # [B,T,1,D]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return (x * c + torch.cat([-x2, x1], dim=-1) * s).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """The decode cache: per layer a K and a V tensor ``[B, KV, max_len,
    D]`` in the compute dtype, and ``index``, the slot the next token
    writes. An attention call with it writes its K/V at ``index`` in place;
    the LM advances ``index``."""

    k: list
    v: list
    index: int = 0

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, device) -> "KVCache":
        shape = (batch, cfg.kv_heads, cfg.max_len, cfg.head_dim)
        return cls([torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.n_layers)],
                   [torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.n_layers)])


def grouped_attention(q, k, v, mask, sqrt_d: float, dtype: torch.dtype) -> torch.Tensor:
    """The einsum core of GQA attention without repeating K/V: q ``[B, T,
    H, D]``; k, v ``[B, KV, L, D]`` views; mask bool, broadcastable to
    ``[B, H, T, L]``. The scores are divided by ``sqrt_d`` in ``dtype``,
    masked with ``finfo(dtype).min`` and softmaxed in f32, as
    :meth:`Attention._attend`'s einsum path; returns ``[B, T, H, D]``. The
    products take the (B, KV) batch dims in k's storage order, so a
    head-major cache (B outer) and a KV-major gather (KV outer) are both
    read in place."""
    B, T, H, D = q.shape
    KV, L = k.shape[1], k.shape[2]
    G = H // KV
    perm = (1, 0, 2, 3) if k.stride(1) > k.stride(0) else (0, 1, 2, 3)  # its own inverse
    # query head h reads kv head h // G, as jnp.repeat(k, G, axis=2) gives
    qg = q.reshape(B, T, KV, G, D).permute(0, 2, 3, 1, 4).reshape(B, KV, G * T, D)
    scores = torch.matmul(qg.permute(perm), k.permute(perm).transpose(-1, -2)) / sqrt_d
    scores = scores.permute(perm).reshape(B, H, T, L)
    scores = scores.masked_fill(~mask, torch.finfo(dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    out = torch.matmul(probs.view(B, KV, G * T, L).permute(perm), v.permute(perm))
    return out.permute(perm).reshape(B, KV, G, T, D).permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


class Attention(nn.Module):
    """Multi-head / grouped-query attention; the score/softmax/value core
    dispatches on ``cfg.attn_impl``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.attn_impl not in ("einsum", "flash", "ring", "ulysses"):
            raise ValueError(f"attn_impl must be 'einsum', 'flash', 'ring' or 'ulysses', "
                             f"got {cfg.attn_impl!r}")
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

    def project(self, x, positions=None):
        """q ``[B, T, H, D]`` and k, v ``[B, T, KV, D]`` of ``x``, RoPE
        applied at ``positions`` (default ``0..T-1``) when the config uses
        it."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = dense(self.q, x, cfg.dtype).view(B, T, H, D)
        k = dense(self.k, x, cfg.dtype).view(B, T, KV, D)
        v = dense(self.v, x, cfg.dtype).view(B, T, KV, D)
        if cfg.use_rope:
            if positions is None:
                positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
            cos, sin = rope_tables(D, cfg.max_len, cfg.rope_theta, str(x.device))
            qk = apply_rope(torch.cat([q, k], dim=2), cos, sin, positions)  # both in one pass
            q, k = qk[:, :, :H], qk[:, :, H:]
        return q, k, v

    def _attend(self, q, k, v, mask):
        cfg = self.cfg
        # flash takes padding (kv-position) masks; an arbitrary [.., Q, K]
        # mask takes the einsum path
        mask_is_kv_shaped = (mask is not None and mask.dim() == 4
                             and mask.shape[1] == 1 and mask.shape[2] == 1)
        eligible = mask is None or mask_is_kv_shaped
        kv_mask = mask[:, 0, 0, :] if mask_is_kv_shaped else None
        impl = cfg.attn_impl
        if impl in ("ring", "ulysses") and eligible:
            # the JAX module's dispatch: sequence parallelism only on a mesh
            # whose seq axis is larger than 1, else the local flash kernel
            from ...parallel.mesh import current_mesh

            mesh = current_mesh()
            if mesh is not None and mesh.axis_sizes.get(cfg.seq_axis, 1) > 1:
                from ...ops import ring_attention_sharded, ulysses_attention_sharded

                # the rows are this process's already: no batch split
                sharded = ulysses_attention_sharded if impl == "ulysses" \
                    else ring_attention_sharded
                return sharded(mesh, q, k, v, kv_mask=kv_mask, causal=cfg.causal,
                               seq_axis=cfg.seq_axis, batch_axes=())
            import warnings

            warnings.warn(f"attn_impl={impl!r} requested but no mesh with a "
                          f"'{cfg.seq_axis}' axis (size>1) is in scope; using the local "
                          f"flash kernel instead", stacklevel=2)
            impl = "flash"
        if impl == "flash" and eligible:
            return flash_attention(q, k, v, kv_mask=kv_mask, causal=cfg.causal)

        if cfg.causal:
            causal = make_causal_mask(q.shape[1], k.shape[1], device=q.device)
            mask = causal if mask is None else mask & causal
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / self._sqrt_d
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(cfg.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def forward(self, x, mask=None, positions=None, kv=None):
        """``kv``: ``(k_cache, v_cache, index)`` of this layer for a decode
        call: this call's K/V land at ``index..index+T-1`` and the queries
        attend over the whole cache under ``mask``, which then already holds
        the causal mask at that offset (:meth:`Encoder.forward` combines
        them once for every layer); never flash, as in the JAX module."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q, k, v = self.project(x, positions)
        if kv is not None:
            ck, cv, start = kv
            ck[:, :, start:start + T] = k.transpose(1, 2)
            cv[:, :, start:start + T] = v.transpose(1, 2)
            out = grouped_attention(q, ck, cv, mask, self._sqrt_d, cfg.dtype)
            return dense(self.o, out.reshape(B, T, H * D), cfg.dtype)
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


def _xavier_experts_(w: torch.Tensor) -> None:
    """Flax's ``xavier_uniform`` on an ``[E, in, out]`` expert kernel: the
    expert axis counts as a receptive field, so the limit is ``sqrt(6 /
    (E*in + E*out))``."""
    E, n_in, n_out = w.shape
    lim = math.sqrt(6.0 / (E * n_in + E * n_out))
    with torch.no_grad():
        w.uniform_(-lim, lim)


class MoEBlock(nn.Module):
    """Switch-transformer MoE MLP: top-k routing, capacity-bucketed dispatch,
    per-expert MLPs; the counterpart of the JAX ``MoEBlock``.

    * The router (``router.weight [E, H]``, no bias) runs in f32 on an f32
      copy of the activations, keeps its f32 weight, and takes the top k of
      its softmax, ties to the lowest expert index (``lax.top_k``'s order;
      ``torch.topk`` orders ties otherwise), through a stable sort. Gates
      are renormalised over the k chosen for k > 1; k = 1 keeps the raw
      probability.
    * Capacity ``C = max(ceil(cf * S * k / E), 1)`` on the host, the
      reference's expression. First choices fill an expert before any
      second choice; an assignment past C is dropped (its token's residual
      carries it).
    * ``scatter``: the S*k assignments choice-major, stably sorted by
      expert, slot = position within the expert, rows past C to one extra
      drop row; each token's k contributions come back through the inverse
      permutation as ``[k, S, H]`` and are summed in choice order, so the
      result does not depend on the order of atomic adds for any k.
      ``einsum``: the ``[S, E, C]`` one-hot dispatch and combine tensors
      built choice by choice.
    * Experts: ``w_up``/``w_gate [E, H, M]``, ``w_dn [E, M, H]``, ``b_up
      [E, M]``, ``b_dn [E, H]``; each product accumulates in f32 and rounds
      to ``cfg.dtype`` once, the biases added there; SwiGLU when
      ``gated_mlp``.
    * The load-balance term ``E * sum_e f_e * P_e`` (``f_e`` averaged over
      all k choices) is kept as ``aux_loss`` after a forward with grad
      enabled (the JAX module's ``sow``), for the trainer to collect; it is
      None after an inference forward. Padding rows route and take
      capacity, as in the reference.
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.moe_dispatch not in ("einsum", "scatter"):
            raise ValueError(f"moe_dispatch must be 'einsum' or 'scatter', got "
                             f"{cfg.moe_dispatch!r}")
        self.cfg = cfg
        E, H, M, pd = cfg.moe_experts, cfg.hidden, cfg.mlp_dim, cfg.param_dtype
        self.router = nn.Linear(H, E, bias=False, dtype=pd)
        self.w_up = nn.Parameter(torch.empty(E, H, M, dtype=pd))
        self.b_up = nn.Parameter(torch.zeros(E, M, dtype=pd))
        if cfg.gated_mlp:
            self.w_gate = nn.Parameter(torch.empty(E, H, M, dtype=pd))
        self.w_dn = nn.Parameter(torch.empty(E, M, H, dtype=pd))
        self.b_dn = nn.Parameter(torch.zeros(E, H, dtype=pd))
        self.aux_loss: torch.Tensor | None = None
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """Expert kernels as Flax draws them, biases 0 (the router is an
        ``nn.Linear`` with its own initialiser)."""
        if self.w_up.is_meta:
            return
        for w in (self.w_up, getattr(self, "w_gate", None), self.w_dn):
            if w is not None:
                _xavier_experts_(w)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_dn.zero_()

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """``[E, C, H]`` rows through each expert's MLP, in ``cfg.dtype``."""
        cfg = self.cfg
        dt = cfg.dtype
        up = torch.bmm(expert_in, self.w_up.to(dt)) + self.b_up[:, None, :].to(dt)
        if cfg.gated_mlp:
            h = _ACTS[cfg.act](torch.bmm(expert_in, self.w_gate.to(dt))) * up
        else:
            h = _ACTS[cfg.act](up)
        return torch.bmm(h, self.w_dn.to(dt)) + self.b_dn[:, None, :].to(dt)

    def forward(self, x):
        cfg = self.cfg
        E, k, dt = cfg.moe_experts, cfg.moe_top_k, cfg.dtype
        B, T, H = x.shape
        S = B * T
        dev = x.device
        xf = x.reshape(S, H)
        probs = torch.softmax(F.linear(xf.float(), self.router.weight.float()), dim=-1)
        C = max(int(math.ceil(cfg.moe_capacity_factor * S * k / E)), 1)
        gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
        gate_vals = probs.gather(1, gate_idx)  # [S, k]
        if k > 1:
            gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        experts = torch.arange(E, device=dev)

        if cfg.moe_dispatch == "scatter":
            expert_flat = gate_idx.t().reshape(S * k)  # choice-major
            order = torch.argsort(expert_flat, stable=True)
            e_sorted = expert_flat[order]
            # counted with a static-size reduction: bincount would read its
            # length back from the card, which a captured step cannot do
            counts = (expert_flat[:, None] == experts).sum(0)
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(S * k, device=dev) - starts[e_sorted]  # slot within the expert
            buf_sorted = torch.where(pos < C, e_sorted * C + pos, E * C)
            buf = torch.empty_like(buf_sorted).scatter_(0, order, buf_sorted)  # choice-major
            expert_in = xf.new_zeros((E * C + 1, H), dtype=dt).index_copy(
                0, buf, xf.to(dt).repeat(k, 1))
            out_e = self._experts(expert_in[:E * C].view(E, C, H))
            rows = out_e.reshape(E * C, H).index_select(0, buf.clamp_max(E * C - 1))
            w = gate_vals.t() * (buf < E * C).view(k, S).float()  # [k, S]
            contrib = rows.view(k, S, H).float() * w[..., None]
            y = contrib[0]
            for j in range(1, k):
                y = y + contrib[j]
        else:
            slots = torch.arange(C, device=dev)
            dispatch = torch.zeros((S, E, C), dtype=dt, device=dev)
            combine = torch.zeros((S, E, C), dtype=torch.float32, device=dev)
            fill = torch.zeros(E, dtype=torch.long, device=dev)
            for j in range(k):
                e_oh = (gate_idx[:, j, None] == experts).long()  # [S, E]
                # position within the chosen expert, after earlier choices' slots
                pos = (torch.cumsum(e_oh, 0) - e_oh + fill) * e_oh
                pos_tok = pos.sum(1)  # [S]; past C its one-hot row is 0
                slot = (pos_tok[:, None] == slots).to(dt)  # [S, C]
                d = e_oh.to(dt)[:, :, None] * slot[:, None, :]
                dispatch = dispatch + d
                combine = combine + d.float() * gate_vals[:, j, None, None]
                fill = fill + e_oh.sum(0)
            expert_in = torch.einsum("sec,sh->ech", dispatch, xf.to(dt))
            y = torch.einsum("sec,ech->sh", combine, self._experts(expert_in).float())

        if torch.is_grad_enabled():
            frac_tokens = (gate_idx[..., None] == experts).float().mean(dim=(0, 1))
            self.aux_loss = E * torch.sum(frac_tokens * probs.mean(0))
        else:
            self.aux_loss = None
        return y.reshape(B, T, H).to(dt)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.post = cfg.norm_position == "post"
        self.attn = Attention(cfg)
        self.norm1 = _norm(cfg)
        self.mlp = MoEBlock(cfg) if cfg.moe_experts > 0 else MlpBlock(cfg)
        self.norm2 = _norm(cfg)

    def forward(self, x, mask=None, positions=None, kv=None):
        if self.post:
            # original-BERT residual structure: add then norm
            x = self.norm1(x + self.attn(x, mask, positions, kv))
            return self.norm2(x + self.mlp(x))
        x = x + self.attn(self.norm1(x), mask, positions, kv)
        return x + self.mlp(self.norm2(x))


class Encoder(nn.Module):
    """Stack of blocks; pre-norm stacks end with a final norm."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = _norm(cfg) if cfg.norm_position != "post" else None

    def forward(self, x, mask=None, positions=None, cache: KVCache | None = None):
        if cache is not None:
            causal = make_causal_mask(x.shape[1], cache.k[0].shape[2], offset=cache.index,
                                      device=x.device)
            mask = causal if mask is None else mask & causal
        for i, layer in enumerate(self.layers):
            kv = None if cache is None else (cache.k[i], cache.v[i], cache.index)
            x = layer(x, mask, positions, kv)
        return x if self.norm is None else self.norm(x)
