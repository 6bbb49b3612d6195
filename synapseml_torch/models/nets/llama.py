"""Llama-family causal LM on torch: dense decode with a KV cache, and the
paged modules the decode engine runs.

Counterpart of ``synapseml_tpu/models/flax_nets/llama.py``: RMSNorm +
SwiGLU + RoPE + GQA, the ``lm_head`` in f32. One module's weights drive
every path (the dense :func:`generate`, and :func:`paged_prefill`,
:func:`paged_decode_step`, :func:`paged_extend`, :func:`paged_verify`), as
one Flax param tree drives both there. Where the JAX functions take
``(model, params)`` or ``(cfg, params)``, these take the :class:`LlamaLM`
that holds its weights.

* :func:`generate` keeps the JAX layout: prompt slots ``0..P-1``,
  generated slots from ``P``, RoPE position ``lengths + i``, a kv mask over
  the whole ``max_len``, the first token read at the last real prompt
  position, the early exit once every row is done, and the refusal of
  ``P + max_new_tokens > max_len``.
* Paged KV: a page pool is one ``[n_blocks, block_len, KV, D]`` tensor a
  layer, written in place (the JAX engine donates its pools instead).
  Block 0 is the trash page: pad tokens and inactive slots write there, and
  it is never read as live. Decode-mode attention gathers each row's pages
  through its block table, as the JAX module does: no custom kernel.
* Sampling draws Gumbel noise from a ``torch.Generator`` seeded with a
  key :func:`fold_in` derives from ``(seed, ...)``, so a stream is a pure
  function of its key on a device, though not the bits of ``jax.random``.
  Greedy selection is exact.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch import nn

from .bert import _embedding
from .transformer import (Encoder, KVCache, TransformerConfig, dense, grouped_attention,
                          make_causal_mask)

__all__ = ["llama2_7b", "llama_tiny", "LlamaLM", "generate", "greedy_generate", "fold_in",
           "PagedLlamaLM", "paged_prefill", "paged_decode_step", "paged_extend",
           "paged_verify", "early_exit_model"]


def llama2_7b(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=32000, hidden=4096, n_layers=32, n_heads=32,
                    n_kv_heads=32, mlp_dim=11008, max_len=4096, norm="rmsnorm",
                    act="silu", gated_mlp=True, causal=True, use_rope=True)
    defaults.update(kw)
    return TransformerConfig(**defaults)


def llama_tiny(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    mlp_dim=128, max_len=128, norm="rmsnorm", act="silu",
                    gated_mlp=True, causal=True, use_rope=True)
    defaults.update(kw)
    return TransformerConfig(**defaults)


class LlamaLM(nn.Module):
    """[B,T] ids -> [B,T,V] f32 logits; with a :class:`KVCache` the call
    decodes (its K/V land in the cache at ``cache.index``) and returns
    ``(logits, cache advanced by T)``.

    Parameter names: ``embed``, ``wpe`` (``learned_pos`` only),
    ``decoder.layers.<i>.{norm1,norm2,attn.{q,k,v,o},mlp.{gate,up,down}}``,
    ``decoder.norm`` and ``lm_head`` — :func:`..convert_jax.
    llama_state_dict_from_flax` maps the Flax tree onto them."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embed = _embedding(cfg.vocab_size, cfg.hidden, pd)
        if cfg.learned_pos:  # GPT-2-family absolute position embeddings
            self.wpe = _embedding(cfg.max_len, cfg.hidden, pd)
        self.decoder = Encoder(cfg)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False, dtype=pd)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, input_ids, positions=None, attention_mask=None,
                cache: KVCache | None = None):
        cfg = self.cfg
        # gather then cast: bitwise Flax's cast-the-table-then-gather
        x = self.embed(input_ids).to(cfg.dtype)
        if cfg.learned_pos:
            B, T = input_ids.shape
            pos = (positions if positions is not None
                   else torch.arange(T, device=x.device)[None, :].expand(B, T))
            x = x + self.wpe(pos).to(cfg.dtype)
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        x = self.decoder(x, mask, positions, cache)
        logits = dense(self.lm_head, x, torch.float32)
        if cache is None:
            return logits
        return logits, dataclasses.replace(cache, index=cache.index + input_ids.shape[1])


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------

_KEY_MASK = (1 << 63) - 1


def fold_in(key: int, *data: int) -> int:
    """A new 63-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``): blake2b of their int64 bytes."""
    words = np.asarray([int(key) & _KEY_MASK] + [int(d) for d in data], np.int64)
    return int.from_bytes(hashlib.blake2b(words.tobytes(), digest_size=8).digest(),
                          "little") & _KEY_MASK


def _categorical(logits: torch.Tensor, key: int) -> torch.Tensor:
    """One draw a row from softmax(``logits``), by the Gumbel-max trick as
    ``jax.random.categorical``; -inf entries are never drawn."""
    g = torch.Generator(device=logits.device)
    g.manual_seed(key)
    u = torch.rand(logits.shape, generator=g, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _make_selector(temperature: float, top_k: int | None, top_p: float | None):
    """Token selection ``[B,V] logits, key -> [B] ids`` (int64).
    temperature <= 0 is greedy argmax; otherwise categorical sampling after
    top-k, then nucleus (top-p) filtering on the renormalised top-k — the
    JAX selector's order (HF's)."""
    if temperature is None or temperature <= 0.0:
        def select(logits, key):
            return torch.argmax(logits, dim=-1)
        return select

    def select(logits, key):
        lg = logits.float() / temperature
        V = lg.shape[-1]
        k = top_k if (top_k is not None and 0 < top_k < V) else V
        if top_p is not None and top_p < 1.0:
            vals, idx = torch.topk(lg, k, dim=-1)  # descending
            probs = torch.softmax(vals, dim=-1)
            # keep tokens whose EXCLUSIVE cumulative mass is < top_p (the
            # most likely token always survives)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            j = _categorical(vals.masked_fill(~keep, -torch.inf), key)
            return idx.gather(1, j[:, None])[:, 0]
        if k < V:
            vals, idx = torch.topk(lg, k, dim=-1)
            return idx.gather(1, _categorical(vals, key)[:, None])[:, 0]
        return _categorical(lg, key)
    return select


# ---------------------------------------------------------------------------
# dense decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate(model: LlamaLM, prompt_ids, max_new_tokens: int, eos_id: int | None = None,
             prompt_mask=None, temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None, rng: int | None = None) -> torch.Tensor:
    """Prefill + a decode loop over a :class:`KVCache` of ``max_len`` slots.

    ``prompt_ids`` ``[B, P]`` is padded to a fixed prompt bucket;
    ``prompt_mask`` ``[B, P]`` marks real tokens (1) and right-padding (0):
    pads are masked out of attention and the first generated token reads the
    logits of the last real prompt token. Generated tokens land at ``P,
    P+1, ...`` whatever a row's prompt length. Returns int32 ``[B, P +
    max_new_tokens]`` on the model's device. temperature <= 0 decodes
    greedily; otherwise step ``i`` samples with key ``fold_in(rng, i)``."""
    cfg = model.cfg
    device = model.device
    ids = torch.as_tensor(prompt_ids, device=device).long()
    B, P = ids.shape
    if P + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds the KV "
            f"cache capacity max_len={cfg.max_len}")
    mask = (torch.ones((B, P), dtype=torch.long, device=device) if prompt_mask is None
            else torch.as_tensor(prompt_mask, device=device).long())
    lengths = mask.sum(-1)
    select = _make_selector(temperature, top_k, top_p)
    rng = 0 if rng is None else int(rng)

    cache = KVCache.zeros(cfg, B, device)
    # kv-cache-wide validity: prompt pads stay masked for the whole decode
    kv_mask = torch.ones((B, cfg.max_len), dtype=torch.long, device=device)
    kv_mask[:, :P] = mask
    prefill_pos = torch.arange(P, device=device)[None, :].expand(B, P)
    logits, cache = model(ids, positions=prefill_pos, attention_mask=kv_mask, cache=cache)
    last_real = logits[torch.arange(B, device=device), lengths - 1]
    next_tok = select(last_real, fold_in(rng, 0))

    out = torch.zeros((B, P + max_new_tokens), dtype=torch.long, device=device)
    out[:, :P] = ids
    out[:, P] = next_tok
    done = None if eos_id is None else next_tok == eos_id
    for i in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            break
        # cache slot P+i (static layout); RoPE position is the row's true
        # token index, so padded prompts keep their relative distances
        logits, cache = model(out[:, P + i:P + i + 1], positions=(lengths + i)[:, None],
                              attention_mask=kv_mask, cache=cache)
        nxt = select(logits[:, -1], fold_in(rng, i + 1))
        if done is not None:
            done = done | (nxt == eos_id)
            nxt = torch.where(done, eos_id, nxt)
        out[:, P + i + 1] = nxt
    return out.to(torch.int32)


def greedy_generate(model: LlamaLM, prompt_ids, max_new_tokens: int,
                    eos_id: int | None = None, prompt_mask=None) -> torch.Tensor:
    """Greedy decode: :func:`generate` at temperature 0."""
    return generate(model, prompt_ids, max_new_tokens, eos_id=eos_id,
                    prompt_mask=prompt_mask, temperature=0.0)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def _paged_attention(attn, x, k_pages, v_pages, positions, flat_idx, gather_idx, mask):
    """One layer's GQA attention over its page pool: this call's K/V are
    scattered to ``flat_idx`` (the trash page absorbs non-writes) BEFORE a
    decode-mode gather, so a token in a multi-token window sees the earlier
    window tokens through the pool; prefill mode (``gather_idx`` None)
    attends over the in-flight K/V."""
    cfg = attn.cfg
    B, T, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = attn.project(x, positions)
    n_slots = k_pages.shape[0] * k_pages.shape[1]
    k_flat = k_pages.view(n_slots, KV, D)
    v_flat = v_pages.view(n_slots, KV, D)
    k_flat.index_copy_(0, flat_idx, k.reshape(B * T, KV, D).to(k_flat.dtype))
    v_flat.index_copy_(0, flat_idx, v.reshape(B * T, KV, D).to(v_flat.dtype))
    if gather_idx is None:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    else:  # decode: each row's logical KV stream, gathered KV-major ([KV, B*L, D])
        L = gather_idx.numel() // B
        k, v = (flat.permute(1, 0, 2).index_select(1, gather_idx).view(KV, B, L, D)
                .transpose(0, 1) for flat in (k_flat, v_flat))
    out = grouped_attention(q, k, v, mask, attn._sqrt_d, cfg.dtype)
    return dense(attn.o, out.reshape(B, T, H * D), cfg.dtype)


class PagedLlamaLM:
    """[B,T] ids -> [B,T,V] f32 logits over a page pool, with
    :class:`LlamaLM`'s weights. ``k_pages`` / ``v_pages``: one ``[n_blocks,
    block_len, KV, D]`` tensor a layer, updated in place.

    ``mode='prefill'``: self-attention over the (padded) prompt under a
    causal + pad mask, each real token's K/V written to its page slot.
    ``mode='decode'``: K/V gathered from the pool through the block table.
    ``write_pos`` ``[B,T]``: page-slot index per token (-1: the trash page);
    ``kv_mask_len``: ``[B]`` attendable logical positions, or ``[B,T]``
    per-token horizons for multi-token decode-mode windows."""

    def __init__(self, model: LlamaLM, block_len: int, mode: str = "decode"):
        cfg = model.cfg
        if cfg.norm_position != "pre" or cfg.learned_pos:
            raise ValueError("the paged engine supports pre-norm RoPE/causal "
                             "decoder configs (the Llama family)")
        self.model, self.block_len, self.mode = model, int(block_len), mode

    def __call__(self, input_ids, k_pages, v_pages, block_tables, positions,
                 write_pos, kv_mask_len):
        m, bl = self.model, self.block_len
        B, T = input_ids.shape
        device = input_ids.device
        wp = write_pos.clamp_min(0)
        block_of = torch.gather(block_tables, 1, wp // bl)
        flat_idx = torch.where(write_pos >= 0, block_of * bl + wp % bl, 0).reshape(-1)
        if self.mode == "prefill":
            # the prompt is self-contained; pads carry write_pos = -1
            gather_idx = None
            mask = (write_pos >= 0)[:, None, None, :] & make_causal_mask(T, T, device=device)
        else:
            L = block_tables.shape[1] * bl
            gather_idx = (block_tables[:, :, None] * bl
                          + torch.arange(bl, device=device)).reshape(-1)
            ar = torch.arange(L, device=device)
            if kv_mask_len.dim() == 2:
                # a growing per-token horizon is intra-window causality
                mask = (ar[None, None, :] < kv_mask_len[:, :, None])[:, None]
            else:
                mask = (ar[None, :] < kv_mask_len[:, None])[:, None, None, :]
        x = m.embed(input_ids).to(m.cfg.dtype)
        for i, layer in enumerate(m.decoder.layers):
            x = x + _paged_attention(layer.attn, layer.norm1(x), k_pages[i], v_pages[i],
                                     positions, flat_idx, gather_idx, mask)
            x = x + layer.mlp(layer.norm2(x))
        return dense(m.lm_head, m.decoder.norm(x), torch.float32)


def _last_real(logits, lengths):
    return logits[torch.arange(logits.shape[0], device=logits.device),
                  (lengths - 1).clamp_min(0)]


@torch.no_grad()
def paged_prefill(model: LlamaLM, block_len: int, prompt_ids, prompt_mask, block_tables,
                  k_pages, v_pages) -> torch.Tensor:
    """Prompt -> last-real-token logits ``[B,V]``; pages written in place.
    Real token t writes page ``block_tables[b, t // bl]`` slot ``t % bl``
    (pads go to the trash page), so each sequence's pages hold its dense
    token stream."""
    B, P = prompt_ids.shape
    t_idx = torch.arange(P, device=prompt_ids.device)[None, :].expand(B, P)
    write_pos = torch.where(prompt_mask > 0, t_idx, -1)
    lengths = (prompt_mask > 0).long().sum(-1)
    logits = PagedLlamaLM(model, block_len, "prefill")(
        prompt_ids, k_pages, v_pages, block_tables, t_idx, write_pos, lengths)
    return _last_real(logits, lengths)


@torch.no_grad()
def paged_decode_step(model: LlamaLM, block_len: int, tokens, seq_lens, active,
                      block_tables, k_pages, v_pages) -> torch.Tensor:
    """One token a slot -> logits ``[S,V]``. ``seq_lens``: tokens already in
    the sequence (this token's position); inactive slots write to the trash
    page and give logits the scheduler ignores."""
    active = active.bool()
    positions = seq_lens[:, None]
    write_pos = torch.where(active[:, None], positions, -1)
    kv_mask_len = torch.where(active, seq_lens + 1, 1)
    logits = PagedLlamaLM(model, block_len, "decode")(
        tokens[:, None], k_pages, v_pages, block_tables, positions, write_pos, kv_mask_len)
    return logits[:, 0]


@torch.no_grad()
def paged_extend(model: LlamaLM, block_len: int, suffix_ids, suffix_mask, start_pos,
                 block_tables, k_pages, v_pages) -> torch.Tensor:
    """Suffix prefill over a prefix-cached sequence -> last-real logits
    ``[B,V]``: decode-mode attention over the pooled prefix, a per-token
    horizon keeping the window causal; ``start_pos`` ``[B]`` is the
    position of the suffix's first token."""
    B, Q = suffix_ids.shape
    t_idx = torch.arange(Q, device=suffix_ids.device)[None, :].expand(B, Q)
    positions = start_pos[:, None] + t_idx
    real = suffix_mask > 0
    write_pos = torch.where(real, positions, -1)
    kv_mask_len = torch.where(real, positions + 1, 1)
    lengths = real.long().sum(-1)
    logits = PagedLlamaLM(model, block_len, "decode")(
        suffix_ids, k_pages, v_pages, block_tables, positions, write_pos, kv_mask_len)
    return _last_real(logits, lengths)


@torch.no_grad()
def paged_verify(model: LlamaLM, block_len: int, tokens, seq_lens, active, block_tables,
                 k_pages, v_pages) -> torch.Tensor:
    """Speculative verify window -> logits ``[S,W,V]``: ``tokens`` ``[S,W]``
    is the last committed token then W-1 drafts, ``seq_lens`` the position
    of the first. Rejected drafts' page writes lie past the sequence's
    committed tokens and are overwritten later: no rollback."""
    active = active.bool()
    S, W = tokens.shape
    positions = seq_lens[:, None] + torch.arange(W, device=tokens.device)[None, :]
    write_pos = torch.where(active[:, None], positions, -1)
    kv_mask_len = torch.where(active[:, None], positions + 1, 1)
    return PagedLlamaLM(model, block_len, "decode")(
        tokens, k_pages, v_pages, block_tables, positions, write_pos, kv_mask_len)


def early_exit_model(model: LlamaLM, n_layers: int) -> LlamaLM:
    """The early-exit draft model (the role of ``early_exit_params``):
    ``embed``, ``lm_head``, the final norm and the first ``n_layers`` layers
    of ``model``, shared, not copied; run over the first ``n_layers`` page
    pools it is the self-draft forward."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    with torch.device("meta"):
        sub = LlamaLM(dataclasses.replace(cfg, n_layers=0))
    sub.cfg = cfg
    sub.embed, sub.lm_head = model.embed, model.lm_head
    sub.decoder.layers = nn.ModuleList(list(model.decoder.layers[:n_layers]))
    sub.decoder.norm = model.decoder.norm
    return sub
