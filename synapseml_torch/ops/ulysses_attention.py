"""All-to-all (DeepSpeed-Ulysses) sequence parallelism.

Counterpart of ``synapseml_tpu/ops/ulysses_attention.py``. Where the ring
keeps tokens resident and rotates K/V, Ulysses swaps which dim is sharded
for the attention itself:

  [B, T/n, H, D]  --all_to_all-->  [B, T, H/n, D]

on the ``seq`` group (``all_to_all_single``), runs full-context attention
for its head group locally (by default the port's ``flash_attention``: the
CUDA flash forward and backward kernels on the card, their plain version on
the CPU), and a second all-to-all restores the token sharding. Each
all-to-all's backward is the inverse all-to-all. Needs
``n_heads % axis_size == 0``.
"""

from __future__ import annotations

import torch

from .attention import flash_attention, reference_attention
from .ring_attention import seq_parallel_apply

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _a2a(mesh_ctx, axis: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` ``[n, ...]``: part j goes to seq member j; returns the parts
    received, part j from member j."""
    group = mesh_ctx.process_group(axis)
    if group is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)  # contiguous too: the collective writes it linearly
    dist.all_to_all_single(out, x, group=group)
    return out


def _heads_to_tokens(mesh_ctx, axis, x):
    """``[B, T/n, H, D]`` (tokens sharded) -> ``[B, T, H/n, D]`` (heads)."""
    n = mesh_ctx.group_size(axis)
    B, Tl, H, D = x.shape
    parts = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)   # [n, B, Tl, H/n, D]
    got = _a2a(mesh_ctx, axis, parts)                              # part j: member j's tokens
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _tokens_to_heads(mesh_ctx, axis, y):
    """``[B, T, H/n, D]`` -> ``[B, T/n, H, D]``."""
    n = mesh_ctx.group_size(axis)
    B, T, Hl, D = y.shape
    parts = y.reshape(B, n, T // n, Hl, D).permute(1, 0, 2, 3, 4)   # [n, B, Tl, H/n, D]
    got = _a2a(mesh_ctx, axis, parts)                              # part j: member j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hl, D)


class _HeadsToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh_ctx, axis):
        ctx.mesh, ctx.axis = mesh_ctx, axis
        return _heads_to_tokens(mesh_ctx, axis, x)

    @staticmethod
    def backward(ctx, g):
        return _tokens_to_heads(ctx.mesh, ctx.axis, g), None, None


class _TokensToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh_ctx, axis):
        ctx.mesh, ctx.axis = mesh_ctx, axis
        return _tokens_to_heads(mesh_ctx, axis, y)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_tokens(ctx.mesh, ctx.axis, g), None, None


def ulysses_attention(q, k, v, kv_mask=None, *, mesh_ctx, axis_name: str = "seq",
                      causal: bool = False, local_impl: str = "flash"):
    """Per-process body: q, k, v ``[B, T/n, H, D]`` shards in global token
    order, ``kv_mask`` ``[B, T/n]``; returns ``[B, T/n, H, D]``.
    ``local_impl``: 'flash' (bounded memory, the default) or 'einsum'
    (plain attention: materializes ``[T, T]`` scores)."""
    n = mesh_ctx.group_size(axis_name)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs n_heads ({H}) divisible by the '{axis_name}' axis "
                         f"size ({n})")
    qh, kh, vh = (_HeadsToTokens.apply(x, mesh_ctx, axis_name) for x in (q, k, v))
    full_mask = None
    if kv_mask is not None:
        from ..parallel.collectives import all_gather_dim

        full_mask = all_gather_dim(mesh_ctx, kv_mask.to(torch.int32), axis_name, 1)
    if local_impl == "flash":
        out = flash_attention(qh, kh, vh, kv_mask=full_mask, causal=causal)
    else:
        out = reference_attention(qh, kh, vh, kv_mask=full_mask, causal=causal)
    return _TokensToHeads.apply(out, mesh_ctx, axis_name)


def ulysses_attention_sharded(mesh_ctx, q, k, v, kv_mask=None, causal: bool = False,
                              seq_axis: str = "seq", batch_axes=("data", "fsdp"),
                              head_axis: str | None = "tensor", local_impl: str = "flash"):
    """Full-array entry point (the mirror of ``ring_attention_sharded``):
    every process passes the same global ``[B, T, H, D]`` q, k, v (T
    divisible by the seq size, H by the seq size times any head-axis
    sharding) and gets the whole output."""
    return seq_parallel_apply(
        mesh_ctx, q, k, v, kv_mask, seq_axis, batch_axes, head_axis,
        lambda q_, k_, v_, m_: ulysses_attention(q_, k_, v_, m_, mesh_ctx=mesh_ctx,
                                                 axis_name=seq_axis, causal=causal,
                                                 local_impl=local_impl),
        head_needs_seq_factor=True)
