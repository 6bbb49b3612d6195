"""Ring attention: sequence parallelism over the mesh's ``seq`` axis.

Counterpart of ``synapseml_tpu/ops/ring_attention.py``. Each process holds
a ``[B, T_local, H, D]`` shard of q, k and v (global position of local row
t on seq member i: ``i * T_local + t``); the K/V shards travel round the
ring (``batch_isend_irecv`` on the ``seq`` group: each member sends to the
next and receives from the previous), and every member folds each visiting
block into a running softmax (max, denominator, f32 accumulator). The block
step is chunked over keys (at most ``[B, H, T_local, chunk]`` live scores)
and is plain torch, as the JAX block step is plain XLA.

:class:`_RingAttention` has the JAX custom VJP's contract: it saves only
the output and the log-sum-exp, recomputes the probabilities on each ring
step of the backward, and sends the dK/dV accumulators round the ring with
their blocks, so that after a full turn they are back at their owner.
Matmul operands keep the input dtype's rounding (bf16 probabilities and
gradients are rounded to bf16 before their products, as JAX rounds them)
and every product and statistic is float32.

At a ``seq`` axis of size 1 the ring has one member and no communication:
the chunked block step over the whole sequence (the JAX package takes its
plain attention there; the port keeps the bounded-memory loop).
"""

from __future__ import annotations

import math

import torch

__all__ = ["ring_attention", "ring_attention_sharded", "seq_parallel_apply"]

_NEG_INF = -1e30


def _pick_chunk(t_local: int, chunk: int) -> int:
    """Largest divisor of ``t_local`` that is <= ``chunk``."""
    c = min(chunk, t_local)
    while t_local % c:
        c -= 1
    return max(c, 1)


def _mm_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (the matmul operand's), computed in f32."""
    return x.to(dtype).float() if dtype != torch.float32 else x.float()


def _scores(qf, ks, ms, q_pos, kv_pos0, start, causal, scale):
    C = ks.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, ks.float()) * scale
    s = torch.where(ms[:, None, None, :], s, _NEG_INF)
    if causal:
        kv_pos = kv_pos0 + start + torch.arange(C, device=qf.device)
        allowed = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(allowed[None, None], s, _NEG_INF)
    return s


def _block_fwd(q, q_pos, k_blk, v_blk, mask_blk, kv_pos0: int, causal: bool, m, l, acc,
               chunk: int):
    """Fold one K/V block into the running softmax, chunk by chunk.
    q/k/v ``[B, T, H, D]``; mask ``[B, T]`` bool; m, l ``[B, H, T]``; acc
    ``[B, H, T, D]`` (f32)."""
    T, D = k_blk.shape[1], q.shape[3]
    C = _pick_chunk(T, chunk)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    for start in range(0, T, C):
        ks, vs = k_blk[:, start:start + C], v_blk[:, start:start + C]
        s = _scores(qf, ks, mask_blk[:, start:start + C], q_pos, kv_pos0, start, causal, scale)
        new_m = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        # gated: fully masked rows keep p == 0 (zero output, zero gradient)
        p = torch.where(s <= _NEG_INF * 0.5, 0.0, torch.exp(s - new_m[..., None]))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", _mm_operand(p, vs.dtype), vs.float())
        m = new_m
    return m, l, acc


def _block_bwd(q, q_pos, k_blk, v_blk, mask_blk, kv_pos0: int, causal: bool, lse, do, delta,
               dq, dk_blk, dv_blk, chunk: int):
    """One visiting block's backward: local dq and the block's travelling
    dk/dv (all f32). lse, delta ``[B, H, T]``; do ``[B, H, T, D]``."""
    T, D = k_blk.shape[1], q.shape[3]
    C = _pick_chunk(T, chunk)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    dof = do.float()
    for start in range(0, T, C):
        ks, vs = k_blk[:, start:start + C], v_blk[:, start:start + C]
        s = _scores(qf, ks, mask_blk[:, start:start + C], q_pos, kv_pos0, start, causal, scale)
        p = torch.where(s <= _NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
        dv_c = torch.einsum("bhqk,bhqd->bkhd", _mm_operand(p, do.dtype), dof)
        dp = torch.einsum("bhqd,bkhd->bhqk", dof, vs.float())
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", _mm_operand(ds, ks.dtype), ks.float()) * scale
        dk_c = torch.einsum("bhqk,bqhd->bkhd", _mm_operand(ds, q.dtype), qf) * scale
        dk_blk[:, start:start + C] += dk_c
        dv_blk[:, start:start + C] += dv_c
    return dq, dk_blk, dv_blk


def _ring(mesh_ctx, axis: str):
    """``permute(x)``: the previous ring member's ``x`` (bool tensors travel
    as uint8)."""
    from ..parallel.collectives import ring_permute

    hop = ring_permute(mesh_ctx, axis, 1)

    def permute(x):
        if x.dtype == torch.bool:
            return hop(x.to(torch.uint8)).bool()
        return hop(x)

    return permute


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, mesh_ctx, axis, causal, chunk):
        B, T, H, D = q.shape
        n = mesh_ctx.group_size(axis)
        my = mesh_ctx.group_index(axis)
        permute = _ring(mesh_ctx, axis)
        q_pos = my * T + torch.arange(T, device=q.device)
        m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
        k_cur, v_cur, mask_cur = k, v, kv_mask
        for s in range(n):
            origin = (my - s) % n
            m, l, acc = _block_fwd(q, q_pos, k_cur, v_cur, mask_cur, origin * T, causal,
                                   m, l, acc, chunk)
            if s < n - 1:
                k_cur, v_cur, mask_cur = permute(k_cur), permute(v_cur), permute(mask_cur)
        out = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, H, T, D]
        lse = m + torch.log(torch.clamp(l, min=1e-30))              # [B, H, T]
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.chunk = mesh_ctx, axis, causal, chunk
        return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        mesh_ctx, axis, causal, chunk = ctx.mesh, ctx.axis, ctx.causal, ctx.chunk
        B, T, H, D = q.shape
        n = mesh_ctx.group_size(axis)
        my = mesh_ctx.group_index(axis)
        permute = _ring(mesh_ctx, axis)
        q_pos = my * T + torch.arange(T, device=q.device)
        do = g.permute(0, 2, 1, 3).to(q.dtype)                      # [B, H, T, D]
        delta = torch.sum(do.float() * out, dim=-1)                 # [B, H, T]
        dq = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros_like(dq)
        dv_cur = torch.zeros_like(dq)
        k_cur, v_cur, mask_cur = k, v, kv_mask
        for s in range(n):
            origin = (my - s) % n
            dq, dk_cur, dv_cur = _block_bwd(q, q_pos, k_cur, v_cur, mask_cur, origin * T,
                                            causal, lse, do, delta, dq, dk_cur, dv_cur, chunk)
            # dk/dv travel with their block; after n hops they are home
            if s < n - 1:
                k_cur, v_cur, mask_cur = permute(k_cur), permute(v_cur), permute(mask_cur)
            dk_cur, dv_cur = permute(dk_cur), permute(dv_cur)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, mesh_ctx, axis_name: str = "seq", kv_mask=None,
                   causal: bool = False, chunk: int = 512):
    """Blockwise ring attention over ``axis_name`` on this process's shards
    ``[B, T_local, H, D]`` (equal-length shards in global token order);
    ``kv_mask`` ``[B, T_local]`` for the local K/V rows. Fully masked query
    rows give zeros. Differentiable (:class:`_RingAttention`)."""
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    return _RingAttention.apply(q, k, v, kv_mask.bool(), mesh_ctx, axis_name, causal, chunk)


# ---- the full-array wrapper shared with Ulysses ----------------------------

def _take(x, mesh_ctx, dims):
    """This process's block of ``x`` along each ``(dim, axes)``."""
    for d, axes in dims:
        n = mesh_ctx.group_size(axes)
        size = x.shape[d] // n
        x = x.narrow(d, mesh_ctx.group_index(axes) * size, size)
    return x.contiguous()


class _Shard(torch.autograd.Function):
    """This process's block of a tensor every process holds whole; the
    backward gathers the blocks' gradients (the whole gradient, on every
    process)."""

    @staticmethod
    def forward(ctx, x, mesh_ctx, dims):
        ctx.mesh, ctx.dims = mesh_ctx, dims
        return _take(x, mesh_ctx, dims)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, g.contiguous(), ctx.dims), None, None


class _Gather(torch.autograd.Function):
    """The whole tensor from every process's block; the backward takes this
    process's block of the (identical on every process) gradient."""

    @staticmethod
    def forward(ctx, x, mesh_ctx, dims):
        ctx.mesh, ctx.dims = mesh_ctx, dims
        return _gather(mesh_ctx, x.contiguous(), dims)

    @staticmethod
    def backward(ctx, g):
        return _take(g, ctx.mesh, ctx.dims), None, None


def _gather(mesh_ctx, x, dims):
    from ..parallel.collectives import all_gather_dim

    for d, axes in reversed(dims):
        x = all_gather_dim(mesh_ctx, x, axes, d)
    return x


def seq_parallel_apply(mesh_ctx, q, k, v, kv_mask, seq_axis: str, batch_axes, head_axis,
                       fn, head_needs_seq_factor: bool = False):
    """The full-array wrapper of the sequence-parallel strategies: every
    process holds the same ``[B, T, H, D]`` q, k, v; each takes its block
    (batch over ``batch_axes``, tokens over ``seq_axis``, heads over
    ``head_axis`` when the head count divides its size, times the seq size
    with ``head_needs_seq_factor``), runs ``fn(q, k, v, kv_mask)`` on it and
    gathers the output whole. Differentiable, the gradients whole on every
    process."""
    sizes = mesh_ctx.axis_sizes
    B, T, H, _ = q.shape
    n = sizes.get(seq_axis, 1)
    batch = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    divisor = max(sizes.get(head_axis, 1), 1) * (n if head_needs_seq_factor else 1) \
        if head_axis else 1
    head = head_axis if (head_axis and sizes.get(head_axis, 1) > 1
                         and H % divisor == 0) else None
    dims = []
    if batch:
        if B % mesh_ctx.group_size(batch):
            raise ValueError(f"batch {B} does not divide over {batch} "
                             f"({mesh_ctx.group_size(batch)})")
        dims.append((0, batch))
    if n > 1:
        if T % n:
            raise ValueError(f"sequence length {T} does not divide over '{seq_axis}' ({n})")
        dims.append((1, (seq_axis,)))
    if head:
        dims.append((2, (head,)))
    if kv_mask is None:
        kv_mask = torch.ones((B, T), dtype=torch.bool, device=q.device)
    q_l, k_l, v_l = (_Shard.apply(x, mesh_ctx, dims) for x in (q, k, v))
    mask_l = _take(kv_mask.bool(), mesh_ctx, [(d, a) for d, a in dims if d < 2])
    out = fn(q_l, k_l, v_l, mask_l)
    return _Gather.apply(out, mesh_ctx, dims)


def ring_attention_sharded(mesh_ctx, q, k, v, kv_mask=None, causal: bool = False,
                           seq_axis: str = "seq", batch_axes=("data", "fsdp"),
                           head_axis: str | None = "tensor", chunk: int = 512):
    """Full-array entry point: every process passes the same global
    ``[B, T, H, D]`` q, k, v (T divisible by the seq size) and gets the
    whole output; :func:`ring_attention` runs on its block. A module
    whose rows are already this process's (the trainer's) passes
    ``batch_axes=()``."""
    return seq_parallel_apply(
        mesh_ctx, q, k, v, kv_mask, seq_axis, batch_axes, head_axis,
        lambda q_, k_, v_, m_: ring_attention(q_, k_, v_, mesh_ctx, seq_axis, m_, causal,
                                              chunk))
