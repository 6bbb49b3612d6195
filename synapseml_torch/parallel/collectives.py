"""Collectives over the mesh's named sub-groups.

Counterpart of ``synapseml_tpu/parallel/collectives.py``, whose helpers
wrap ``shard_map`` bodies around ``lax.psum``/``ppermute``. Torch runs one
process a device, so each helper here returns a function of THIS process's
tensor that runs the collective over the group of the named axes
(:meth:`MeshContext.process_group`). A group of one member (an axis of size
1, or no process group) makes every collective the identity, with no call
into ``torch.distributed``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .mesh import MeshContext, _map_leaves

__all__ = ["psum_over", "pmean_over", "all_gather_over", "data_parallel_map",
           "ring_permute", "all_reduce_", "all_gather_dim"]


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_reduce_(mesh_ctx: MeshContext, x: torch.Tensor, axis="data", op: str = "sum"
                ) -> torch.Tensor:
    """``x`` reduced in place over the group of ``axis`` (``op``: sum | max |
    min); returns ``x``."""
    group = mesh_ctx.process_group(_axes(axis))
    if group is None:
        return x
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dist.all_reduce(x, op=ops[op], group=group)
    return x


def all_gather_dim(mesh_ctx: MeshContext, x: torch.Tensor, axis="data", dim: int = 0
                   ) -> torch.Tensor:
    """The group's pieces of ``x`` (equal shapes) concatenated along
    ``dim`` in group order."""
    axes = _axes(axis)
    group = mesh_ctx.process_group(axes)
    if group is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh_ctx.group_size(axes))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def psum_over(mesh_ctx: MeshContext, axis: str | Sequence[str] = "data"):
    """``fn(x) -> x`` summed over ``axis`` (a new tensor)."""
    return lambda x: all_reduce_(mesh_ctx, x.clone(), axis, "sum")


def pmean_over(mesh_ctx: MeshContext, axis: str = "data"):
    """``fn(x) -> x`` averaged over ``axis``."""
    n = mesh_ctx.group_size(_axes(axis))
    return lambda x: all_reduce_(mesh_ctx, x.clone(), axis, "sum") / n


def all_gather_over(mesh_ctx: MeshContext, axis: str = "data", tiled: bool = True):
    """``fn(x)``: the group's pieces of ``x`` concatenated along dim 0
    (``tiled``) or stacked on a new leading dim."""
    def run(x):
        if tiled:
            return all_gather_dim(mesh_ctx, x, axis, 0)
        return all_gather_dim(mesh_ctx, x.unsqueeze(0), axis, 0)

    return run


def ring_permute(mesh_ctx: MeshContext, axis: str = "seq", shift: int = 1):
    """``fn(x)``: the tensor of the member ``shift`` places before this one
    on the ``axis`` ring (each member sends to the one ``shift`` after it),
    by ``batch_isend_irecv``. The building block of ring attention."""
    n = mesh_ctx.group_size(axis)

    def run(x):
        if n == 1 or shift % n == 0:
            return x.clone()
        import torch.distributed as dist

        ranks = mesh_ctx.group_ranks(axis)
        i = mesh_ctx.group_index(axis)
        x = x.contiguous()
        out = torch.empty_like(x)
        group = mesh_ctx.process_group(axis)
        ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
               dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    return run


def data_parallel_map(mesh_ctx: MeshContext, fn: Callable, reduce: str | None = "mean"):
    """``run(batch)``: ``fn`` on this process's rows of a global host batch
    (:meth:`MeshContext.shard_batch`). ``reduce='mean'`` averages every
    output leaf with a leading dim over the GLOBAL rows (the local row sums
    summed over the data axes); scalars pass through; None returns this
    process's outputs."""
    axes = ("data", "fsdp")

    def run(batch: Any):
        out = fn(mesh_ctx.shard_batch(batch))
        if reduce != "mean":
            return out

        def mean(x):
            x = torch.as_tensor(x)
            if x.dim() == 0:
                return x
            total = all_reduce_(mesh_ctx, torch.sum(x, dim=0), axes, "sum")
            return total / (x.shape[0] * mesh_ctx.group_size(axes))

        return _map_leaves(mean, out)

    return run
