"""The shared per-shard top-k scorer: one ``|q|^2 - 2 q.x + |x|^2`` product
and a top-k, the engine behind ``nn/knn.py`` and :class:`VectorIndexModel`.

Counterpart of ``synapseml_tpu/retrieval/scorer.py``. The JAX package runs
this as an XLA matmul and ``lax.top_k``, no Pallas kernel, so the port runs
a ``torch.matmul`` in float32 (TF32 off, torch's default, which the chip
check also sets) and a top-k on the tensors' device. Callables come from the
process ``CompiledCache`` under :data:`FN_ID`, keyed by shape (query rung,
shard rows, dim, k, variant) and never by shard, as the JAX executables are:
the shard matrix is an argument, so every shard of one shape shares one
ladder of entries.

Ties: ``lax.top_k`` puts the lowest index first among equal values, while
``torch.topk`` leaves the order of ties open (on CUDA it varies). Integer-
valued embeddings (the hashing embedder's) tie at the k-th distance often,
so :func:`topk_smallest` takes ``torch.topk``'s values, which are exact,
and chooses the columns itself: every entry below the k-th value, then the
lowest columns equal to it (a second top-k, over int32 column numbers),
ordered by (value, column). That is ``lax.top_k(-dist, k)``'s selection
and order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import batching as cb
from ..core.device import resolve_device

__all__ = ["INF", "FN_ID", "score_shard", "score_batches", "topk_smallest"]

# distance of a masked-out candidate (the conditional KNN bias); below the
# float32 maximum so that the additive mask cannot overflow to inf
INF = np.float32(3.0e38)

FN_ID = "retrieval_score_shard"


def topk_smallest(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of float32 ``dist`` [B, N] and
    their columns, ordered by (value, column): ``lax.top_k(-dist, k)``'s
    ids, ties to the lowest column. -0.0 counts as +0.0."""
    n = dist.shape[1]
    vals, pos = torch.topk(dist, k, dim=1, largest=False, sorted=True)
    kth = vals[:, -1:]
    below = (vals < kth).sum(dim=1, keepdim=True)  # all in any top-k, at the front
    cols = torch.arange(n, device=dist.device, dtype=torch.int32)
    tied = torch.where(dist == kth, cols, n)  # the k-th value's columns, others past the end
    lowest, _ = torch.topk(tied, k, dim=1, largest=False, sorted=True)
    slot = torch.arange(k, device=dist.device)
    fill = torch.gather(lowest, 1, (slot - below).clamp_min(0)).to(pos.dtype)
    pos = torch.where(slot < below, pos, fill)
    # order by (value, column): stable sorts by column, then by value
    pos = torch.gather(pos, 1, torch.sort(pos, dim=1, stable=True).indices)
    vals = torch.gather(dist, 1, pos) + 0.0  # -0.0 + 0.0 = +0.0
    order = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(pos, 1, order)


def _shard_fn(bucket: int, n: int, d: int, k: int, variant: str):
    """The (Q, X, x_sq[, bias]) -> (dist, idx) callable of one shape, from
    the shared ``CompiledCache`` (no instance: nothing of a caller is
    captured, so KNN, VectorIndexModel and the chip check share entries)."""
    def build():
        def fn(Q, X, x_sq, bias=None):
            # [B, N] squared L2 distances from one matmul
            dist = (torch.sum(Q * Q, dim=1, keepdim=True)
                    - torch.matmul(2.0 * Q, X.T) + x_sq[None, :])
            if bias is not None:
                dist = dist + bias
            return topk_smallest(dist, k)

        return fn

    return cb.get_compiled_cache().get(
        FN_ID, (bucket, n, d, k, variant), build, dtype="float32")


def _on(a, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device).contiguous()


def score_shard(Qb, X: torch.Tensor, x_sq: torch.Tensor, k: int, bias=None):
    """Top-k of one padded query bucket ``Qb`` [B, D] against one shard
    ``X`` [N, D] on its device (``x_sq``: its rows' squared norms, computed
    once a shard). Returns numpy ``(dist [B, k'], idx [B, k'])``, squared L2
    distances, ``k' = min(k, N)``. ``bias`` [B, N] is an additive mask (0
    allowed, :data:`INF` excluded: the conditional KNN contract)."""
    dev = X.device
    Qb = _on(Qb, dev)
    n, d = X.shape
    kk = min(int(k), n)
    variant = "bias" if bias is not None else "plain"
    fn = _shard_fn(Qb.shape[0], n, d, kk, variant)
    with torch.inference_mode():
        if bias is None:
            dist, idx = fn(Qb, X, x_sq)
        else:
            dist, idx = fn(Qb, X, x_sq, _on(bias, dev))
        return dist.cpu().numpy(), idx.cpu().numpy()


def score_batches(Q, X, k: int, *, x_sq=None, bias_fn=None,
                  bucketer: cb.ShapeBucketer | None = None,
                  query_batch: int = 256, device="cuda"):
    """Score every query row of ``Q`` against one shard ``X``, the queries in
    ladder-bucketed padded batches (``bucketer.slices``), so a mixed-size
    query stream builds at most ladder-many callables a shard shape.

    ``X`` (and ``x_sq``) may be tensors already on a device, which is then
    the one used; host arrays go to ``device`` ("cuda" unless the caller
    asks for "cpu"). ``bias_fn(s, e)`` returns the [e-s, N] additive mask of
    one query slice, or None. Returns numpy ``(dist [n, k'], idx [n, k'])``
    of squared L2 distances."""
    dev = X.device if torch.is_tensor(X) else resolve_device("score_batches", device)
    X = _on(X, dev)
    x_sq = (torch.sum(X * X, dim=1) if x_sq is None else _on(x_sq, dev))
    Q = np.asarray(Q.cpu() if torch.is_tensor(Q) else Q, np.float32)
    n = len(Q)
    kk = min(int(k), X.shape[0])
    dist = np.empty((n, kk), np.float32)
    idx = np.empty((n, kk), np.int64)
    bucketer = bucketer or cb.default_bucketer()
    for s, e, bucket in bucketer.slices(n, query_batch):
        Qb = cb.pad_rows(Q[s:e], bucket)
        bias = bias_fn(s, e) if bias_fn is not None else None
        if bias is not None:
            bias = cb.pad_rows(np.asarray(bias, np.float32), bucket)
        db, ib = score_shard(Qb, X, x_sq, kk, bias)
        dist[s:e] = db[:e - s]
        idx[s:e] = ib[:e - s]
    return dist, idx
