"""Blockwise (flash) attention — a hand-written CUDA kernel and its plain version.

Counterpart of ``synapseml_tpu/ops/attention.py``. The Pallas TPU kernel
``_flash_fwd_kernel`` becomes ``csrc/flash_fwd.cu``, launched by
:func:`flash_attention_fwd` for CUDA tensors; :func:`flash_attention_fwd_plain`
is the same blockwise online softmax in plain PyTorch, which the wrapper
takes for CPU tensors and which the chip check holds the kernel against.

Layout contract: ``q, k, v: [B, T, H, D]`` at the public face (as in
:mod:`models.nets`), ``kv_mask: [B, T]`` boolean (True = attend). Fully
masked query rows output exactly zero.

Forward only: the scoring path runs under ``torch.inference_mode()``. The
``autograd.Function`` with the recompute-from-LSE backward comes with the
training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["reference_attention", "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "BLOCK", "HEAD_DIMS"]

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


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_kernel_args(q, k, v, kv_mask) -> None:
    tensors = {"q": q, "k": k, "v": v, "kv_mask": kv_mask}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: the kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_mask.dtype != torch.int32:
        raise TypeError(f"flash_attention_fwd: kv_mask must be int32, got {kv_mask.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: want q [BH,Tq,D], k and v [BH,Tk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Tq, D = q.shape
    if k.shape[0] != BH or k.shape[2] != D or Tq < 1:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: the kernel takes head dims {HEAD_DIMS}, "
                         f"got {D}")
    if tuple(kv_mask.shape) != (BH, k.shape[1]):
        raise ValueError(f"flash_attention_fwd: kv_mask must be [BH, Tk] = "
                         f"{(BH, k.shape[1])}, got {tuple(kv_mask.shape)}")


def flash_attention_fwd(q, k, v, kv_mask, causal: bool = False,
                        scale: float | None = None):
    """Flash-attention forward on ``[BH, T, D]``: ``(out, lse)``.

    CUDA tensors launch ``csrc/flash_fwd.cu`` (built at first use) or raise;
    CPU tensors take :func:`flash_attention_fwd_plain`. Each kernel launch
    adds one to ``flash_attention_fwd.launches``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    _check_kernel_args(q, k, v, kv_mask)
    BH, Tq, D = q.shape
    fn = _build.load("flash_fwd").flash_fwd
    fn.argtypes = _FLASH_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), BH, Tq, k.shape[1], D, int(causal),
                 float(scale), _KERNEL_DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_head_dim(D: int) -> int:
    return next((d for d in HEAD_DIMS if d >= D), D)


def flash_attention(q, k, v, kv_mask=None, causal: bool = False):
    """Fused blockwise attention forward. [B, T, H, D] layout.

    Pads T to the block and D to the kernel's nearest head dim (zero-padding
    D leaves dot products unchanged; padded kv positions are masked; padded
    q rows are sliced away). The scale stays at the true D."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention is forward-only; its backward "
                                  "comes with the training slice")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if causal and Tq != Tk:
        # the kernel aligns q/kv positions at 0 with no offset; a causal mask
        # with Tq != Tk would be silently misaligned
        raise ValueError(f"causal flash_attention requires Tq == Tk, got "
                         f"Tq={Tq} Tk={Tk}")
    if kv_mask is None:
        kv_mask = torch.ones((B, Tk), dtype=torch.bool, device=q.device)

    block_q = min(BLOCK, _ceil_to(Tq, 8))
    block_k = min(BLOCK, _ceil_to(Tk, 8))
    Tq_p, Tk_p = _ceil_to(Tq, block_q), _ceil_to(Tk, block_k)
    Dp = _padded_head_dim(D)
    scale = 1.0 / math.sqrt(D)  # true head dim — padding D must not change it

    def to_bh(x, T, Tp):
        if Tp != T or Dp != D:
            x = F.pad(x, (0, Dp - D, 0, 0, 0, Tp - T))
        return x.permute(0, 2, 1, 3).reshape(B * H, Tp, Dp).contiguous()

    maskb = kv_mask.to(torch.int32)
    if Tk_p != Tk:
        maskb = F.pad(maskb, (0, Tk_p - Tk))
    maskb = maskb[:, None, :].expand(B, H, Tk_p).reshape(B * H, Tk_p).contiguous()
    out, _ = flash_attention_fwd(to_bh(q, Tq, Tq_p), to_bh(k, Tk, Tk_p),
                                 to_bh(v, Tk, Tk_p), maskb, causal, scale)
    out = out.reshape(B, H, Tq_p, Dp)[:, :, :Tq, :D]
    return out.permute(0, 2, 1, 3)
