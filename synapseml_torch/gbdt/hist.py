"""Level histograms of GBDT growth — a hand-written CUDA kernel and its plain versions.

Counterpart of ``synapseml_tpu/gbdt/pallas_hist.py`` (the Pallas TPU
kernel ``_hist_kernel`` behind ``pallas_segment_histogram``) and of the
three backends of ``trees._level_histogram``:

* ``segment``: one ``index_add_`` per feature (XLA's ``segment_sum`` in the
  JAX package);
* ``onehot``: row-chunked one-hot matmuls, as the JAX package phrases it for
  the TPU's matrix unit;
* ``pallas``: :func:`fixed_point_histogram`, which launches
  ``csrc/gbdt_hist.cu`` for CUDA tensors — one launch per level, every
  feature at once — and takes :func:`fixed_point_histogram_plain` for CPU
  tensors. The name stays so that saved params carry across; on this package
  it names the CUDA kernel.

The kernel is deterministic: it sums values turned into 64-bit integers
with one power-of-two scale per channel (see the source's note), so two
launches on the same inputs give bitwise-equal histograms, and its plain
version reproduces it bit for bit. ``segment`` and ``onehot`` add floats,
and on the card ``index_add_`` adds them in a different order every run.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import _build

__all__ = ["level_histogram", "node_totals", "segment_histogram",
           "fixed_point_histogram", "fixed_point_histogram_plain", "fixed_point_scales",
           "fixed_point_scales_plain", "fixed_point_tree", "FixedPointTree",
           "HIST_IMPLS"]

HIST_IMPLS = ("segment", "onehot", "pallas")
_ONEHOT_ROW_CHUNK = 4096


def _level_rows(node_of_row, base: int, width: int):
    """``valid`` rows of the level and their node index within it."""
    valid = (node_of_row >= base) & (node_of_row < base + width)
    rel = torch.where(valid, node_of_row - base, 0).to(torch.int64)
    return valid, rel


def _level_data(grad, hess, presence, valid):
    """(N, 3) [grad, hess, count] with rows outside the level zeroed."""
    data = torch.stack([grad, hess, presence], dim=1)
    return torch.where(valid[:, None], data, 0.0)


def _segment_level(bins, data, rel, width, num_bins):
    nf = bins.shape[1]
    WB = width * num_bins
    out = torch.empty((nf, WB, 3), dtype=torch.float32, device=data.device)
    for f in range(nf):  # one feature at a time: peak memory stays O(N)
        seg = rel * num_bins + bins[:, f].to(torch.int64)
        out[f] = torch.zeros((WB, 3), dtype=torch.float32,
                             device=data.device).index_add_(0, seg, data)
    return out.reshape(nf, width, num_bins, 3).transpose(0, 1).contiguous()


def _onehot_level(bins, data, rel, width, num_bins):
    nf = bins.shape[1]
    WB = width * num_bins
    out = torch.empty((nf, WB, 3), dtype=torch.float32, device=data.device)
    for f in range(nf):
        seg = rel * num_bins + bins[:, f].to(torch.int64)
        acc = torch.zeros((WB, 3), dtype=torch.float32, device=data.device)
        for s in range(0, seg.shape[0], _ONEHOT_ROW_CHUNK):
            oh = F.one_hot(seg[s:s + _ONEHOT_ROW_CHUNK], WB).to(torch.float32)  # (C, WB)
            acc = acc + oh.T @ data[s:s + _ONEHOT_ROW_CHUNK]
        out[f] = acc
    return out.reshape(nf, width, num_bins, 3).transpose(0, 1).contiguous()


# ---------------- the fixed-point histogram: kernel and plain version ----------------

def _scale_exps(data: torch.Tensor) -> list[int]:
    """Per-channel exponent k of the kernel's scale 2^k (``scale_exp`` in
    ``csrc/gbdt_hist.cu``): |value| * 2^k < 2^(61 - bitlen(N)) over all N
    rows, so no sum of N scaled values leaves int64."""
    n = data.shape[0]
    maxabs = data.abs().amax(dim=0).tolist() if n else [0.0, 0.0, 0.0]
    return [min(max(61 - n.bit_length() - math.frexp(m)[1], -1000), 1000) for m in maxabs]


def fixed_point_scales_plain(grad, hess, presence) -> torch.Tensor:
    """The kernel's per-tree scale in plain PyTorch: (3,) int32 exponents of
    grad, hess and presence."""
    exps = _scale_exps(torch.stack([grad, hess, presence], dim=1))
    return torch.tensor(exps, dtype=torch.int32, device=grad.device)


def fixed_point_histogram_plain(bins, grad, hess, presence, node_of_row, base: int,
                                width: int, num_bins: int, scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, bit for bit: each channel is
    scaled by 2^k in float64 (exact), rounded half to even to int64, summed
    per (node, feature, bin) with integer adds, and turned back into float32
    as ``float(double(sum) * 2^-k)``. ``scale`` is the (3,) int32 exponents
    k of :func:`fixed_point_scales`; None computes them from these rows.
    ``bins`` None means one feature whose bin is 0 for every row (per-node
    totals). Bins outside ``[0, num_bins)`` and rows whose node is outside
    ``[base, base + width)`` add nothing. Returns (width, F, num_bins, 3)
    float32."""
    n = grad.shape[0]
    nf = 1 if bins is None else bins.shape[1]
    device = grad.device
    data = torch.stack([grad, hess, presence], dim=1)
    exps = _scale_exps(data) if scale is None else [int(k) for k in scale.tolist()]
    factor = torch.tensor([2.0 ** k for k in exps], dtype=torch.float64, device=device)
    q = torch.round(data.to(torch.float64) * factor).to(torch.int64)
    valid, rel = _level_rows(node_of_row, base, width)
    WB = width * num_bins
    acc = torch.zeros((nf, WB + 1, 3), dtype=torch.int64, device=device)  # slot WB: dropped
    for f in range(nf):
        b = (torch.zeros(n, dtype=torch.int64, device=device) if bins is None
             else bins[:, f].to(torch.int64))
        keep = valid & (b >= 0) & (b < num_bins)
        seg = torch.where(keep, rel * num_bins + b, WB)
        acc[f].index_add_(0, seg, q)
    inv = torch.tensor([2.0 ** -k for k in exps], dtype=torch.float64, device=device)
    hist = (acc[:, :WB].to(torch.float64) * inv).to(torch.float32)
    return hist.reshape(nf, width, num_bins, 3).transpose(0, 1).contiguous()


_BIN_BYTES = {torch.uint8: 1, torch.int32: 4}
_PROTOTYPES = {  # ctypes signatures of csrc/gbdt_hist.cu's entry points
    "gbdt_level_hist": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "gbdt_hist_scales": ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2,
                         ctypes.c_int),
    "gbdt_hist_scratch_words": ([ctypes.c_int] * 3, ctypes.c_longlong),
}
_entry_points: dict = {}


def _kernel(name: str):
    """An entry point of the built library, its prototype set once."""
    fn = _entry_points.get(name)
    if fn is None:
        fn = getattr(_build.load("gbdt_hist"), name)
        fn.argtypes, fn.restype = _PROTOTYPES[name]
        _entry_points[name] = fn
    return fn


def _check_rows(grad, hess, presence, node_of_row=None, what="fixed_point_histogram"):
    n = grad.shape[0]
    named = [("grad", grad, torch.float32), ("hess", hess, torch.float32),
             ("presence", presence, torch.float32)]
    if node_of_row is not None:
        named.append(("node_of_row", node_of_row, torch.int32))
    for name, t, dtype in named:
        if t.device != grad.device:
            raise ValueError(f"{what}: {name} is on {t.device}, grad on {grad.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what}: {name} must be ({n},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if n >= 2 ** 31:
        raise ValueError(f"{what}: the kernel takes fewer than 2^31 rows")


def _check_kernel_args(bins, grad, hess, presence, node_of_row, base, width, num_bins,
                       scale=None):
    _check_rows(grad, hess, presence, node_of_row)
    n = grad.shape[0]
    if bins is None:
        if num_bins != 1:
            raise ValueError("fixed_point_histogram: bins=None takes num_bins=1")
    else:
        if bins.device != grad.device:
            raise ValueError(f"fixed_point_histogram: bins is on {bins.device}, "
                             f"grad on {grad.device}")
        if bins.dtype not in _BIN_BYTES:
            raise TypeError(f"fixed_point_histogram: bins must be uint8 or int32, "
                            f"got {bins.dtype}")
        if bins.dim() != 2 or bins.shape[0] != n or bins.shape[1] < 1:
            raise ValueError(f"fixed_point_histogram: bins must be ({n}, F), "
                             f"got {tuple(bins.shape)}")
        if not bins.is_contiguous():
            raise ValueError("fixed_point_histogram: bins must be contiguous")
    if scale is not None and (scale.device != grad.device or scale.dtype != torch.int32
                              or scale.shape != (3,) or not scale.is_contiguous()):
        raise ValueError(f"fixed_point_histogram: scale must be a contiguous (3,) int32 "
                         f"tensor on {grad.device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")
    nf = 1 if bins is None else bins.shape[1]
    if width < 1 or num_bins < 1 or base < 0:
        raise ValueError(f"fixed_point_histogram: want width >= 1, num_bins >= 1 and "
                         f"base >= 0, got {width}, {num_bins}, {base}")
    if width * nf * num_bins * 3 >= 2 ** 31:
        raise ValueError("fixed_point_histogram: the kernel takes fewer than 2^31 "
                         "histogram slots")


def fixed_point_scales(grad, hess, presence) -> torch.Tensor:
    """(3,) int32 exponents of the fixed-point scale of grad, hess and
    presence (float32 (N,) each): computed once a tree and passed to every
    level's :func:`fixed_point_histogram`. CUDA tensors launch the kernel's
    scale pass (one zero fill and one kernel, no host sync; each launch adds
    one to ``fixed_point_scales.launches``); CPU tensors take
    :func:`fixed_point_scales_plain`."""
    if grad.device.type == "cpu":
        return fixed_point_scales_plain(grad, hess, presence)
    if grad.device.type != "cuda":
        raise ValueError(f"fixed_point_scales: no kernel for device {grad.device}")
    _check_rows(grad, hess, presence, what="fixed_point_scales")
    with torch.cuda.device(grad.device):
        buf = torch.zeros(8, dtype=torch.int32, device=grad.device)
        err = _kernel("gbdt_hist_scales")(grad.data_ptr(), hess.data_ptr(),
                                          presence.data_ptr(), grad.shape[0], buf.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gbdt_hist scale kernel launch failed with CUDA error {err}")
    fixed_point_scales.launches += 1
    return buf[4:7]


fixed_point_scales.launches = 0


def _hist_scratch(nf: int, width: int, num_bins: int, device) -> torch.Tensor | None:
    """The zeroed int64 scratch of a kernel launch of this shape, and of every
    launch with fewer nodes (each launch leaves it zeroed): allocate it once a
    tree for the widest level. None for a CPU device (no kernel)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    words = _kernel("gbdt_hist_scratch_words")(nf, width, num_bins)
    return torch.zeros(words, dtype=torch.int64, device=device)


def fixed_point_histogram(bins, grad, hess, presence, node_of_row, base: int,
                          width: int, num_bins: int, scale=None,
                          scratch=None) -> torch.Tensor:
    """(width, F, num_bins, 3) float32 level histogram, deterministic.

    ``bins`` (N, F) uint8 or int32, or None (per-node totals: one feature,
    every row in bin 0, ``num_bins=1``); ``grad``/``hess``/``presence`` (N,)
    float32; ``node_of_row`` (N,) int32. ``scale``: the tree's
    :func:`fixed_point_scales`, or None to compute it here. ``scratch``: the
    tree's :func:`fixed_point_tree` scratch (zeroed, and fitting this
    shape), or None to allocate one.
    CUDA tensors launch ``csrc/gbdt_hist.cu`` (built at first use; one
    kernel, no other device operation, when both are given) or raise; CPU
    tensors take :func:`fixed_point_histogram_plain`. Each level launch adds
    one to ``fixed_point_histogram.launches``."""
    if grad.device.type == "cpu":
        return fixed_point_histogram_plain(bins, grad, hess, presence, node_of_row,
                                           base, width, num_bins, scale)
    if grad.device.type != "cuda":
        raise ValueError(f"fixed_point_histogram: no kernel for device {grad.device}")
    _check_kernel_args(bins, grad, hess, presence, node_of_row, base, width, num_bins, scale)
    n = grad.shape[0]
    nf = 1 if bins is None else bins.shape[1]
    if scale is None:
        scale = fixed_point_scales(grad, hess, presence)
    if scratch is None:
        scratch = _hist_scratch(nf, width, num_bins, grad.device)
    elif scratch.device != grad.device or scratch.dtype != torch.int64:
        raise ValueError("fixed_point_histogram: scratch must be a fixed_point_tree "
                         f"scratch on {grad.device}")
    with torch.cuda.device(grad.device):
        out = torch.empty((width, nf, num_bins, 3), dtype=torch.float32, device=grad.device)
        err = _kernel("gbdt_level_hist")(
            None if bins is None else bins.data_ptr(),
            0 if bins is None else _BIN_BYTES[bins.dtype],
            grad.data_ptr(), hess.data_ptr(), presence.data_ptr(), node_of_row.data_ptr(),
            n, nf, base, width, num_bins, scale.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), grad.device.index,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gbdt_hist kernel launch failed with CUDA error {err}")
    fixed_point_histogram.launches += 1
    return out


fixed_point_histogram.launches = 0


class FixedPointTree(NamedTuple):
    """What every fixed-point launch of one tree shares: the scale of its
    grad/hess/presence and (on the card) the zeroed scratch of its widest
    launch."""

    scale: torch.Tensor
    scratch: torch.Tensor | None


def fixed_point_tree(grad, hess, presence, nf: int, max_depth: int,
                     num_bins: int) -> FixedPointTree:
    """The per-tree state of :func:`fixed_point_histogram` for a tree of
    ``max_depth`` levels of histograms over ``nf`` features, then the final
    level's totals: computed once, before the first level."""
    widest = _hist_scratch(nf, 2 ** max(max_depth - 1, 0), num_bins, grad.device)
    totals = _hist_scratch(1, 2 ** max_depth, 1, grad.device)
    if widest is not None and totals.numel() > widest.numel():
        widest = totals
    return FixedPointTree(fixed_point_scales(grad, hess, presence), widest)


# ---------------- the level histogram and its backends ----------------

def level_histogram(bins, grad, hess, presence, node_of_row, base: int, width: int,
                    num_bins: int, impl: str = "segment",
                    tree: FixedPointTree | None = None) -> torch.Tensor:
    """(width, F, num_bins, 3) histograms for the ``width`` nodes of one
    level, channels (grad, hess, count). Rows whose node is outside
    ``[base, base + width)`` (rows resting in already-final leaves) add
    nothing. ``impl``: 'segment', 'onehot' or 'pallas' (the CUDA kernel,
    which takes the tree's :func:`fixed_point_tree`, or computes its scale
    and scratch itself when ``tree`` is None)."""
    if impl == "pallas":
        return fixed_point_histogram(bins, grad, hess, presence, node_of_row,
                                     base, width, num_bins, *(tree or (None, None)))
    if impl not in HIST_IMPLS:
        raise ValueError(f"hist_impl must be 'segment', 'onehot' or 'pallas', got {impl!r}")
    valid, rel = _level_rows(node_of_row, base, width)
    data = _level_data(grad, hess, presence, valid)
    backend = _segment_level if impl == "segment" else _onehot_level
    return backend(bins, data, rel, width, num_bins)


def node_totals(grad, hess, presence, node_of_row, base: int, width: int,
                impl: str = "segment", tree: FixedPointTree | None = None) -> torch.Tensor:
    """(width, 3) per-node (grad, hess, count) totals of the final level.
    The kernel path sums them with the kernel, so that a whole fit is
    deterministic; the others with one ``index_add_``, as the JAX package
    sums them with ``segment_sum`` whatever the backend. ``tree`` as for
    :func:`level_histogram`."""
    if impl == "pallas":
        return fixed_point_histogram(None, grad, hess, presence, node_of_row, base, width, 1,
                                     *(tree or (None, None))).reshape(width, 3)
    valid, rel = _level_rows(node_of_row, base, width)
    data = _level_data(grad, hess, presence, valid)
    return torch.zeros((width, 3), dtype=torch.float32,
                       device=grad.device).index_add_(0, rel, data)


def segment_histogram(seg, data, num_segments: int) -> torch.Tensor:
    """``segment_sum(data, seg, num_segments)`` through the kernel (the
    counterpart of ``pallas_segment_histogram``): ``seg`` (N,) int ids,
    ``data`` (N, 3) float32; ids outside ``[0, num_segments)`` add nothing.
    Served as one feature with ``num_bins = num_segments`` at one node.
    Returns (num_segments, 3) float32."""
    n = seg.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=seg.device)
    bins = seg.to(torch.int32).reshape(n, 1).contiguous()
    grad, hess, presence = (data[:, c].contiguous() for c in range(3))
    return fixed_point_histogram(bins, grad, hess, presence, node, 0, 1,
                                 num_segments).reshape(num_segments, 3)
