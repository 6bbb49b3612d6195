"""Blockwise (flash) attention — hand-written CUDA kernels and their plain versions.

Counterpart of ``synapseml_tpu/ops/attention.py``. The Pallas TPU kernel
``_flash_fwd_kernel`` becomes ``csrc/flash_fwd.cu``, launched by
:func:`flash_attention_fwd` for CUDA tensors; :func:`flash_attention_fwd_plain`
is the same blockwise online softmax in plain PyTorch, which the wrapper
takes for CPU tensors and which the chip check holds the kernel against.
The backward that ``jax.custom_vjp`` gives it there (``_flash_core_bwd``,
XLA) becomes ``csrc/flash_bwd_bf16.cu`` and ``csrc/flash_bwd_f32.cu``, one
library each, launched by :func:`flash_attention_bwd`,
beside :func:`flash_attention_bwd_plain`: the gradients recomputed blockwise
from the forward's LSE, never the ``[T, T]`` scores.

Layout contract: ``q, k, v: [B, T, H, D]`` at the public face (as in
:mod:`models.nets`), ``kv_mask: [B, T]`` boolean (True = attend). Fully
masked query rows output exactly zero (and get zero gradient). The kernels
take that layout as it is, strided views included, and write contiguous
``[B, T, H, D]`` outputs. The forward runs both types on the tensor cores:
bfloat16 as it is, float32 in split TF32 (each operand split into two TF32
parts, three products a step), which keeps float32 accuracy. The backward
runs bfloat16 on Hopper's warpgroup tensor-core products (wgmma, tiles
brought by TMA) and float32 on the tensor cores in split TF32 too
(mma.sync, tiles brought by cp.async).

:func:`flash_attention` is differentiable: when grad is enabled and an
input requires it, an ``autograd.Function`` saves q, k, v, the mask, the
output and the LSE and runs the backward kernel (its plain version on the
CPU). Otherwise, as when scoring under ``torch.inference_mode()``, it runs
the forward kernel alone.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["reference_attention", "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd", "flash_attention_bwd_plain",
           "BLOCK", "HEAD_DIMS"]

_NEG_INF = -1e30
BLOCK = 64                 # the kernel's query and kv tile
HEAD_DIMS = (32, 64, 128)  # head dims the kernel is built for; D pads up to one


def reference_attention(q, k, v, kv_mask=None, causal: bool = False,
                        q_offset=0, kv_offset=0):
    """Plain attention (the correctness oracle). [B,T,H,D] layout.

    ``q_offset``/``kv_offset`` are global position offsets so sequence-
    parallel shards can build the right causal mask."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
        kv_pos = kv_offset + torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where((kv_pos <= q_pos)[None, None], scores, _NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :].bool(), scores, _NEG_INF)
    any_valid = torch.any(scores > _NEG_INF * 0.5, dim=-1)       # [B,H,Tq]
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(any_valid[..., None], probs, 0.0)         # zero masked rows
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_fwd_plain(q, k, v, kv_mask, causal: bool = False,
                              scale: float | None = None):
    """The kernel's function in plain PyTorch: online softmax over kv blocks.

    ``q: [BH, Tq, D]``, ``k, v: [BH, Tk, D]``, ``kv_mask: [BH, Tk]``
    (nonzero = attend). Returns ``(out [BH, Tq, D] in q's dtype,
    lse f32 [BH, Tq])``. Dots accumulate in f32, the scale applies after
    the dot, P is cast to V's dtype before the PV product, masked entries
    are gated to p = 0, and causal kv blocks wholly above the diagonal are
    skipped — the same gates as the kernel."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    valid_all = kv_mask != 0
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, BLOCK):
        qb = q[:, q0:q0 + BLOCK].float()
        bq = qb.shape[1]
        m = torch.full((BH, bq), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((BH, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BH, bq, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Tk, BLOCK):
            if causal and k0 > q0 + BLOCK - 1:
                break
            kb = k[:, k0:k0 + BLOCK].float()
            vb = v[:, k0:k0 + BLOCK]
            s = torch.bmm(qb, kb.transpose(1, 2)) * scale
            s = torch.where(valid_all[:, None, k0:k0 + BLOCK], s, _NEG_INF)
            if causal:
                q_pos = q0 + torch.arange(bq, device=q.device)[:, None]
                kv_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
                s = torch.where(kv_pos <= q_pos, s, _NEG_INF)
            new_m = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - new_m)
            # gate, not just subtract: on a fully masked row s == new_m ==
            # -1e30 and exp(0) would count masked entries
            p = torch.where(s <= _NEG_INF * 0.5, 0.0, torch.exp(s - new_m[..., None]))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.bmm(p.to(v.dtype).float(), vb.float())
            m = new_m
        safe_l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + bq] = (acc / safe_l[..., None]).to(q.dtype)
        lse[:, q0:q0 + bq] = m + torch.log(safe_l)
    return out, lse


def flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout, causal: bool = False,
                              scale: float | None = None):
    """The backward kernel's function in plain PyTorch: ``(dq, dk, dv)``.

    ``q, out, dout: [BH, Tq, D]``, ``k, v: [BH, Tk, D]``, ``kv_mask:
    [BH, Tk]`` (nonzero = attend), ``lse: f32 [BH, Tq]`` from the forward.
    Step by step the JAX package's ``_flash_core_bwd``, blocked at
    ``BLOCK``: ``delta = rowsum(f32(out) * f32(dout))``; P recomputed as
    ``exp(s - lse)`` from f32 scores, masked to -1e30 and gated to 0 at
    ``s <= -5e29`` (so fully masked rows and padded keys get exactly zero
    gradient); ``dv += P^T dout`` with P in dout's dtype; ``ds = P (dout v^T
    - delta)``; ``dq += scale ds k`` and ``dk += scale ds^T q`` with ds in
    the inputs' dtype. Every product accumulates in f32; the results come
    back in the inputs' dtypes. Causal kv blocks wholly above the diagonal
    are skipped (their P is 0)."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    valid_all = kv_mask != 0
    g = dout.to(q.dtype)
    delta = (out.float() * dout.float()).sum(dim=-1)
    dq = torch.zeros((BH, Tq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((BH, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((BH, Tk, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, BLOCK):
        qb, gb = q[:, q0:q0 + BLOCK], g[:, q0:q0 + BLOCK]
        bq = qb.shape[1]
        lse_b = lse[:, q0:q0 + BLOCK, None]
        delta_b = delta[:, q0:q0 + BLOCK, None]
        for k0 in range(0, Tk, BLOCK):
            if causal and k0 > q0 + BLOCK - 1:
                break
            kb, vb = k[:, k0:k0 + BLOCK], v[:, k0:k0 + BLOCK]
            s = torch.bmm(qb.float(), kb.float().transpose(1, 2)) * scale
            s = torch.where(valid_all[:, None, k0:k0 + BLOCK], s, _NEG_INF)
            if causal:
                q_pos = q0 + torch.arange(bq, device=q.device)[:, None]
                kv_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
                s = torch.where(kv_pos <= q_pos, s, _NEG_INF)
            p = torch.where(s <= _NEG_INF * 0.5, 0.0, torch.exp(s - lse_b))
            dv[:, k0:k0 + BLOCK] += torch.bmm(p.to(g.dtype).float().transpose(1, 2), gb.float())
            dp = torch.bmm(gb.float(), vb.float().transpose(1, 2))
            ds = p * (dp - delta_b)
            dq[:, q0:q0 + BLOCK] += torch.bmm(ds.to(k.dtype).float(), kb.float()) * scale
            dk[:, k0:k0 + BLOCK] += torch.bmm(ds.to(q.dtype).float().transpose(1, 2),
                                              qb.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# q, k, v, mask, out, lse; B, H, Tq, Tk, D; 12 element strides (64-bit: a
# plain c_int would cut them); causal, scale, dtype, stream
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ALIGN = 16  # bytes: both kernels move q, k, v and out in 16-byte vectors


def _head_strides(st, shape) -> list[int]:
    """The (batch, token, head) element strides of a [B, T, H, D] tensor
    (``st = x.stride()``, read once: ``x.stride(i)`` costs microseconds a
    call), 0 for a dim of size 1, whose stride is never used."""
    return [st[0] if shape[0] > 1 else 0, st[1] if shape[1] > 1 else 0,
            st[2] if shape[2] > 1 else 0]


def _aligned(x) -> bool:
    """Whether ``x`` meets the kernel's 16-byte alignment: its base address
    and the strides of its (batch, token, head) dims of size above 1."""
    elt = x.element_size()
    return (x.data_ptr() % _ALIGN == 0
            and all(st * elt % _ALIGN == 0 for st in _head_strides(x.stride(), x.shape)))


def _broadcast(x) -> bool:
    """Whether ``x`` steps by a zero stride along a dim longer than 1 (an
    expanded view, such as k/v of one head expanded over heads)."""
    return any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape))


def _kernel_views(q, k, v, out, dout):
    """The backward kernel's inputs: ``dout`` in q's dtype with D innermost
    and 16-byte aligned (copied once when it is not), and in bfloat16 a
    contiguous copy of any broadcast view (a zero stride on a dim longer
    than 1), since TMA steps by every stride. The float32 kernel copies its
    tiles with cp.async from any address and takes such a view as it is."""
    if dout.dtype != q.dtype or dout.stride()[-1] != 1 or not _aligned(dout):
        dout = dout.to(q.dtype).contiguous()
    views = (q, k, v, out, dout)
    if q.dtype == torch.bfloat16:
        views = tuple(x.contiguous() if _broadcast(x) else x for x in views)
    return views


def _kernel_args(q, k, v, kv_mask, out, dout=None, *, fn: str) -> tuple[int, ...]:
    """The C entry point's dims and element strides for ``q, out:
    [B, Tq, H, D]``, ``k, v: [B, Tk, H, D]`` and an int32 ``kv_mask:
    [B, Tk]``: ``(B, H, Tq, Tk, D)`` then the (batch, token, head) strides
    of q, k, v and out (0 for a dim of size 1), and of ``dout`` (shaped as
    out) when it is given, for the backward. Raises on what the kernels do
    not take, before any launch. It runs on every launch, so it reads each
    shape and stride tuple once."""
    named = (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask), ("out", out))
    if dout is not None:
        named += (("dout", dout),)
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {q.device}")
    dt = q.dtype
    if dt not in _KERNEL_DTYPES or any(t.dtype != dt for _, t in named if t is not kv_mask):
        raise TypeError(f"{fn}: the kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_mask.dtype != torch.int32:
        raise TypeError(f"{fn}: kv_mask must be int32, got {kv_mask.dtype}")
    qs, ks = tuple(q.shape), tuple(k.shape)
    if (len(qs) != 4 or len(ks) != 4 or tuple(v.shape) != ks
            or any(tuple(t.shape) != qs for _, t in named[4:])):
        want_q = "q, out and dout" if dout is not None else "q and out"
        raise ValueError(f"{fn}: want {want_q} [B,Tq,H,D], k and v [B,Tk,H,D], got "
                         + ", ".join(f"{name} {tuple(t.shape)}" for name, t in named
                                     if t is not kv_mask))
    B, Tq, H, D = qs
    Tk = ks[1]
    if ks[0] != B or ks[2:] != qs[2:] or Tq < 1:
        raise ValueError(f"{fn}: q {qs} and k {ks} do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: the kernel takes head dims {HEAD_DIMS}, "
                         f"got {D}")
    if tuple(kv_mask.shape) != (B, Tk) or not kv_mask.is_contiguous():
        raise ValueError(f"{fn}: kv_mask must be a contiguous [B, Tk] = "
                         f"{(B, Tk)}, got {tuple(kv_mask.shape)}")
    args = [B, H, Tq, Tk, D]
    for (name, t), shape in zip(named[:3] + named[4:], (qs, ks, ks, qs, qs)):
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"{fn}: {name} must have D innermost (unit "
                             f"stride), got strides {st}")
        if not _aligned(t):
            raise ValueError(f"{fn}: {name} must be {_ALIGN}-byte aligned "
                             f"(base address and strides), got address {t.data_ptr():#x} "
                             f"and strides {st}")
        args += _head_strides(st, shape)
    return tuple(args)


def _entry_point():
    """The C function ``flash_fwd`` with its argument types set."""
    fn = _build.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _FLASH_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _plain_bthd(plain, q, k, v, kv_mask, *rest):
    """``plain`` (:func:`flash_attention_fwd_plain` or
    :func:`flash_attention_bwd_plain`) on ``[B*H, T, D]`` copies of the
    ``[B, T, H, D]`` q, k, v and of every 4-d tensor in ``rest``, with the
    ``[B, Tk]`` mask repeated over the heads. Its 3-d results come back as
    contiguous ``[B, T, H, D]``; the rest (the LSE) as they are."""
    B, _, H, D = q.shape

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], D)

    mask = kv_mask[:, None, :].expand(B, H, kv_mask.shape[1]).reshape(B * H, -1)
    rest = [to_bh(x) if isinstance(x, torch.Tensor) and x.dim() == 4 else x for x in rest]
    res = plain(to_bh(q), to_bh(k), to_bh(v), mask, *rest)
    return tuple(x.reshape(B, H, x.shape[1], D).permute(0, 2, 1, 3).contiguous()
                 if x.dim() == 3 else x for x in res)


def _flash_fwd_bthd(q, k, v, kv_mask, causal: bool, scale: float):
    """``(out [B, Tq, H, D], lse f32 [B*H, Tq])`` for ``[B, T, H, D]`` q/k/v
    of any strides and an int32 ``kv_mask [B, Tk]``. CUDA tensors launch the
    kernel in place (no copy of q, k, v or out) or raise; CPU tensors take
    :func:`flash_attention_fwd_plain` on ``[B*H, T, D]`` copies."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.device.type == "cpu":
        return _plain_bthd(flash_attention_fwd_plain, q, k, v, kv_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    with torch.cuda.device(q.device):
        out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
        dims = _kernel_args(q, k, v, kv_mask, out, fn="flash_attention_fwd")
        err = _entry_point()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), *dims, int(causal), float(scale),
                 _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with CUDA error {err}")
    flash_attention_fwd.launches[_KERNEL_NAMES[q.dtype]] += 1
    return out, lse


def flash_attention_fwd(q, k, v, kv_mask, causal: bool = False,
                        scale: float | None = None):
    """Flash-attention forward on ``[BH, T, D]``: ``(out, lse)``.

    CUDA tensors launch ``csrc/flash_fwd.cu`` (built at first use; on the
    tensor cores, float32 in split TF32) or raise;
    any strides with D innermost are taken as they are. CPU tensors take
    :func:`flash_attention_fwd_plain`. Each kernel launch adds one to
    ``flash_attention_fwd.launches["bf16"]`` or ``["f32"]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention_fwd: want q [BH,Tq,D], k and v [BH,Tk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    # the same entry point with H = 1: [BH, T, D] is [B=BH, T, 1, D]
    out, lse = _flash_fwd_bthd(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), kv_mask,
                               causal, scale)
    return out.squeeze(2), lse


# Launches that ran, by dtype. A CUDA graph replays kernels without their
# wrapper: a capture counts its calls and the graph's owner takes them back
# and adds them on every replay (models/trainer.py::_ChunkGraph).
flash_attention_fwd.launches = {"bf16": 0, "f32": 0}


# q, k, v, mask, out, dout, lse, scratch, dq, dk, dv; B, H, Tq, Tk, D; 15
# element strides; causal, scale, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 15
                 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_TENSOR_MAP_ERR = 100000  # flash_bwd's code when TMA cannot describe a view


_BWD_SOURCES = {torch.float32: "flash_bwd_f32", torch.bfloat16: "flash_bwd_bf16"}


def _bwd_entry_point(dtype):
    """The C functions ``flash_bwd`` and ``flash_bwd_scratch_bytes`` (B, H,
    Tq, Tk, D -> bytes of scratch a call needs) of ``dtype``'s library
    (``csrc/flash_bwd_bf16.cu`` or ``csrc/flash_bwd_f32.cu``), argument
    types set."""
    lib = _build.load(_BWD_SOURCES[dtype])
    fn, size = lib.flash_bwd, lib.flash_bwd_scratch_bytes
    if fn.argtypes is None:
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_longlong
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn, size


def _flash_bwd_bthd(q, k, v, kv_mask, out, lse, dout, causal: bool, scale: float):
    """``(dq, dk, dv)``, contiguous ``[B, T, H, D]``, for ``[B, T, H, D]``
    q/k/v/out/dout of any strides, an int32 ``kv_mask [B, Tk]`` and the
    forward's ``lse f32 [B*H, Tq]``. CUDA tensors launch the backward kernel
    of their dtype in place or raise (a dout off the kernel's layout is copied once first,
    and so is a broadcast view in bf16, see :func:`_kernel_views`);
    no host sync, and every output and scratch comes from torch's allocator,
    so a CUDA graph can capture the call. CPU tensors take
    :func:`flash_attention_bwd_plain` on ``[B*H, T, D]`` copies."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if q.device.type == "cpu":
        return _plain_bthd(flash_attention_bwd_plain, q, k, v, kv_mask, out, lse, dout, causal,
                           scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    q, k, v, out, dout = _kernel_views(q, k, v, out, dout)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B * H, Tq) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous float32 [B*H, Tq] = "
                         f"{(B * H, Tq)}, got {lse.dtype} {tuple(lse.shape)}")
    with torch.cuda.device(q.device):
        dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
        dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
        dv = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
        dims = _kernel_args(q, k, v, kv_mask, out, dout, fn="flash_attention_bwd")
        fn, size = _bwd_entry_point(q.dtype)
        scratch = torch.empty(size(B, H, Tq, Tk, D), dtype=torch.uint8, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), *dims, int(causal), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err >= _TENSOR_MAP_ERR:
        raise RuntimeError(f"flash_bwd: cuTensorMapEncodeTiled refused an input or output "
                           f"(CUresult {err - _TENSOR_MAP_ERR}); strides {dims[5:]}")
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed with CUDA error {err}")
    flash_attention_bwd.launches[_KERNEL_NAMES[q.dtype]] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, kv_mask, out, lse, dout, causal: bool = False,
                        scale: float | None = None):
    """Flash-attention backward on ``[BH, T, D]``: ``(dq, dk, dv)`` from the
    forward's ``out`` and ``lse`` and the output gradient ``dout``.

    CUDA tensors launch ``csrc/flash_bwd_bf16.cu`` (wgmma and TMA) or
    ``csrc/flash_bwd_f32.cu`` (the tensor cores in split TF32 with
    mma.sync), built at first use, or raise; any strides with D innermost are
    taken as they are, except that bf16 copies a broadcast view (a zero
    stride on a dim longer than 1) first, since TMA steps by every stride.
    CPU tensors take :func:`flash_attention_bwd_plain`. Each call of the
    entry point (one kernel, after a memset of its dQ counters when a head
    has more than one kv tile: Tk > 128, or > 64 at D = 128 in float32)
    adds one to ``flash_attention_bwd.launches["bf16"]`` or ``["f32"]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_mask, out, lse, dout, causal, scale)
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention_bwd: want q [BH,Tq,D], k and v [BH,Tk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    grads = _flash_bwd_bthd(*(x.unsqueeze(2) for x in (q, k, v)), kv_mask, out.unsqueeze(2),
                            lse, dout.unsqueeze(2), causal, scale)
    return tuple(x.squeeze(2) for x in grads)


# Launches that ran, by dtype, counted under CUDA graphs as the forward's are.
flash_attention_bwd.launches = {"bf16": 0, "f32": 0}


class _FlashAttention(torch.autograd.Function):
    """``_flash_fwd_bthd`` with the backward kernel as its gradient: the
    port's ``jax.custom_vjp`` of ``_flash_core``. Saves q, k, v, the mask,
    the output and the LSE; the gradient recomputes P from the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = _flash_fwd_bthd(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_bthd(q, k, v, mask, out, lse, dout, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _padded_head_dim(D: int) -> int:
    return next((d for d in HEAD_DIMS if d >= D), D)


def flash_attention(q, k, v, kv_mask=None, causal: bool = False):
    """Fused blockwise attention. [B, T, H, D] layout, differentiable.

    q, k and v go to the kernel as they are, strided views included, and
    the output comes back as a contiguous ``[B, Tq, H, D]``: no permute and
    no T padding (the kernel masks its ragged tiles). D is zero-padded up
    to the kernel's nearest head dim when it is not one of them (which
    leaves dot products unchanged), and a tensor off the kernel's 16-byte
    alignment is copied first; both stay differentiable. The scale stays at
    the true D. When grad is enabled and q, k or v requires it, the call
    goes through :class:`_FlashAttention`, whose backward is
    :func:`flash_attention_bwd`'s kernel; otherwise the forward kernel runs
    alone."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if causal and Tq != Tk:
        # the kernel aligns q/kv positions at 0 with no offset; a causal mask
        # with Tq != Tk would be silently misaligned
        raise ValueError(f"causal flash_attention requires Tq == Tk, got "
                         f"Tq={Tq} Tk={Tk}")
    scale = 1.0 / math.sqrt(D)  # true head dim — padding D must not change it
    Dp = _padded_head_dim(D)
    if Dp != D:
        q, k, v = (F.pad(x, (0, Dp - D)) for x in (q, k, v))
    else:
        q, k, v = (x if x.stride()[-1] == 1 and _aligned(x)
                   else x.clone(memory_format=torch.contiguous_format) for x in (q, k, v))
    if kv_mask is None:
        mask = torch.ones((B, Tk), dtype=torch.int32, device=q.device)
    else:
        mask = kv_mask.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashAttention.apply(q, k, v, mask, causal, scale)
    else:
        out, _ = _flash_fwd_bthd(q, k, v, mask, causal, scale)
    return out[..., :D] if Dp != D else out
