"""synapseml_torch.ops.attention against synapseml_tpu.ops.attention.

The same numpy inputs go through the JAX functions (the Pallas flash
kernel in interpret mode on the CPU, as tests/test_ops.py runs it) and
through the port, whose CPU tensors take the kernel's plain PyTorch
version. Tolerances: 2e-5 in f32 (the two sum in different orders), 3e-2
for bf16 against the f32 oracle, 1e-5 on the LSE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.ops import attention as tatt
from synapseml_tpu.ops import attention as jatt


def make_qkv(B=2, T=64, H=4, D=32, seed=0):
    rs = np.random.default_rng(seed)
    q, k, v = (rs.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = rs.random((B, T)) > 0.2
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flash_matches_jax(causal, with_mask):
    q, k, v, mask = make_qkv()
    kv_mask = mask if with_mask else None
    jargs = _j(q, k, v) + [None if kv_mask is None else jnp.asarray(kv_mask)]
    targs = _t(q, k, v) + [None if kv_mask is None else torch.from_numpy(kv_mask)]
    want = np.asarray(jatt.flash_attention(*jargs, causal=causal))
    got = tatt.flash_attention(*targs, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    ref = tatt.reference_attention(*targs, causal=causal)
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("q_offset,kv_offset", [(0, 0), (16, 0), (32, 16)])
def test_reference_offsets_match_jax(q_offset, kv_offset):
    q, k, v, mask = make_qkv(T=32, seed=1)
    want = jatt.reference_attention(*_j(q, k, v, mask), causal=True,
                                    q_offset=q_offset, kv_offset=kv_offset)
    got = tatt.reference_attention(*_t(q, k, v, mask), causal=True,
                                   q_offset=q_offset, kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_unaligned_shapes():
    # T not a multiple of the block, D padded up to the kernel's 32
    q, k, v, _ = make_qkv(T=50, D=24, seed=2)
    want = np.asarray(jatt.flash_attention(*_j(q, k, v), causal=True))
    got = tatt.flash_attention(*_t(q, k, v), causal=True)
    assert got.shape == (2, 50, 4, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_fully_masked_rows_zero():
    q, k, v, _ = make_qkv(T=16, seed=3)
    mask = np.zeros((2, 16), bool)
    mask[:, :4] = True
    want = jatt.reference_attention(*_j(q, k, v, mask))
    got = tatt.flash_attention(*_t(q, k, v, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    none = torch.zeros((2, 16), dtype=torch.bool)
    out0 = tatt.flash_attention(*_t(q, k, v), none)
    assert float(out0.abs().max()) == 0.0
    # the kernel-level function: zero output, finite LSE
    qb, kb, vb = (torch.from_numpy(x[:, :, 0]).contiguous() for x in (q, k, v))
    out, lse = tatt.flash_attention_fwd(qb, kb, vb, torch.zeros((2, 16), dtype=torch.int32))
    assert float(out.abs().max()) == 0.0 and bool(torch.isfinite(lse).all())


def test_flash_bf16_matches_f32_reference():
    q, k, v, mask = make_qkv(T=16, seed=4)
    want = np.asarray(jatt.reference_attention(*_j(q, k, v, mask), causal=True))
    qb, kb, vb = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = tatt.flash_attention(qb, kb, vb, torch.from_numpy(mask), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_out_and_lse_match_pallas_core(causal):
    """The kernel-level function against the Pallas kernel's own launcher,
    both on [BH, T, D] with a padding mask that leaves some rows empty."""
    rs = np.random.default_rng(5)
    q, k, v = (rs.normal(size=(6, 32, 32)).astype(np.float32) for _ in range(3))
    mask = rs.random((6, 32)) > 0.3
    mask[0] = False
    scale = 1.0 / np.sqrt(32)
    want_out, want_lse = jatt._flash_core_fwd_impl(*_j(q, k, v, mask), causal, 32, 32, scale)
    got_out, got_lse = tatt.flash_attention_fwd(*_t(q, k, v), torch.from_numpy(mask.astype(np.int32)),
                                                causal, scale)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=1e-5)


def test_causal_needs_equal_lengths():
    q, k, v, _ = make_qkv(T=16)
    with pytest.raises(ValueError, match="Tq == Tk"):
        tatt.flash_attention(*_t(q, k[:, :8], v[:, :8]), causal=True)


def test_cpu_path_counts_no_kernel_launch_and_refuses_grad():
    """The CPU path launches no kernel, forward or backward. It no longer
    refuses inputs that require grad: it differentiates them, through the
    backward kernel's plain version (tests/test_torch_flash_bwd.py holds the
    gradients to the JAX package's)."""
    q, k, v, _ = make_qkv(T=8)
    before = dict(tatt.flash_attention_fwd.launches)
    before_bwd = dict(tatt.flash_attention_bwd.launches)
    tatt.flash_attention(*_t(q, k, v))
    assert tatt.flash_attention_fwd.launches == before
    qg = torch.from_numpy(q).requires_grad_()
    tatt.flash_attention(qg, *_t(k, v)).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())
    assert tatt.flash_attention_fwd.launches == before
    assert tatt.flash_attention_bwd.launches == before_bwd


def _projection_views(B=2, T=50, H=3, D=32, dtype=torch.float32, seed=0):
    """q, k, v as the model makes them: [B, T, H, D] views cut from one
    [B, T, 3*H*D] projection, so none of them is contiguous."""
    rs = np.random.default_rng(seed)
    proj = torch.from_numpy(rs.normal(size=(B, T, 3 * H * D)).astype(np.float32)).to(dtype)
    return [x.unflatten(-1, (H, D)) for x in proj.split(H * D, dim=-1)]


@pytest.mark.parametrize("bad,err,match", [
    ("head_dim", ValueError, "head dims"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("mask_dtype", TypeError, "int32"),
    ("strided", ValueError, "innermost"),
    ("mask_shape", ValueError, r"\[B, Tk\]"),
])
def test_kernel_argument_checks(bad, err, match):
    """What the CUDA wrapper refuses before any launch (checked here on CPU
    tensors; the kernel itself runs only on the card)."""
    q = torch.zeros(2, 16, 2, 64)
    k = torch.zeros(2, 16, 2, 64)
    mask = torch.ones(2, 16, dtype=torch.int32)
    if bad == "head_dim":
        q, k = torch.zeros(2, 16, 2, 48), torch.zeros(2, 16, 2, 48)
    elif bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "mask_dtype":
        mask = mask.bool()
    elif bad == "strided":  # D not innermost
        q = torch.zeros(2, 16, 64, 2).transpose(2, 3)
    elif bad == "mask_shape":
        mask = torch.ones(4, 16, dtype=torch.int32)
    with pytest.raises(err, match=match):
        tatt._kernel_args(q, k, k, mask, torch.empty_like(k), fn="flash_attention_fwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_args_dims_and_strides(dtype):
    """The C call's dims and strides for projection views: no copy, the
    views' own strides; misaligned or D-strided tensors are refused."""
    B, T, H, D = 2, 50, 3, 32
    q, k, v = _projection_views(B, T, H, D, dtype)
    out = torch.empty((B, T, H, D), dtype=dtype)
    mask = torch.ones(B, T, dtype=torch.int32)
    args = tatt._kernel_args(q, k, v, mask, out, fn="flash_attention_fwd")
    view = (T * 3 * H * D, 3 * H * D, D)
    assert args == (B, H, T, T, D, *view, *view, *view, T * H * D, H * D, D)
    # [BH, T, D] as [B=BH, T, 1, D]: a size-1 head dim passes stride 0
    flat = torch.zeros(6, T, D, dtype=dtype)
    args = tatt._kernel_args(*(flat.unsqueeze(2),) * 3, torch.ones(6, T, dtype=torch.int32),
                             torch.empty_like(flat).unsqueeze(2), fn="flash_attention_fwd")
    assert args == (6, 1, T, T, D) + (T * D, D, 0) * 4
    # one element off the 16-byte grid
    shifted = torch.zeros(B * T * H * D + 1, dtype=dtype)[1:].view(B, T, H, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt._kernel_args(shifted, k, v, mask, out, fn="flash_attention_fwd")
    # a token stride that is not a multiple of 16 bytes
    odd = torch.zeros(B, T, H * D + 2, dtype=dtype)[..., :H * D].unflatten(-1, (H, D))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt._kernel_args(q, odd, v, mask, out, fn="flash_attention_fwd")
    d_strided = torch.zeros(B, T, D, H, dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError, match="innermost"):
        tatt._kernel_args(q, k, d_strided, mask, out, fn="flash_attention_fwd")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_flash_from_projection_views_matches_jax(causal, dtype, atol):
    """flash_attention on non-contiguous [B, T, H, D] views of a projection,
    with a padding mask, against the JAX flash_attention (bf16 inputs go to
    JAX as the same values in f32)."""
    q, k, v = _projection_views(B=2, T=50, H=3, D=32, dtype=dtype, seed=6)
    assert not q.is_contiguous()
    mask = np.random.default_rng(6).random((2, 50)) > 0.25
    want = np.asarray(jatt.flash_attention(*_j(*(x.float().numpy() for x in (q, k, v))),
                                           jnp.asarray(mask), causal=causal))
    got = tatt.flash_attention(q, k, v, torch.from_numpy(mask), causal=causal)
    assert got.shape == (2, 50, 3, 32) and got.dtype == dtype and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


# --- the f32 kernel's split TF32, emulated -----------------------------------
# The f32 kernel computes on the tensor cores, which read f32 as TF32 (10
# mantissa bits). It splits each operand x into hi = x rounded to TF32 (as
# cvt.rna.tf32.f32) and lo = x - hi truncated to TF32, and takes each product
# as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32. The emulation below (here only,
# no part of the port) holds that error budget to the f32 tolerances on the
# kernel's plain version.

def _tf32(x):
    """``cvt.rna.tf32.f32``: x to 10 mantissa bits, to nearest, ties away from
    zero. f32 is sign and magnitude, so adding half of the 13 dropped bits'
    range to the bit pattern and clearing them rounds the magnitude."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _bmm_split_tf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return torch.bmm(a_lo, b_hi) + torch.bmm(a_hi, b_lo) + torch.bmm(a_hi, b_hi)


def _bmm_single_tf32(a, b):
    return torch.bmm(_tf32(a), _tf32(b))


def _flash_with(bmm, q, k, v, mask, causal, scale):
    """The recurrence of ``flash_attention_fwd_plain`` (64-row tiles, online
    softmax, the -1e30 fill and gate) with both products through ``bmm``."""
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((BH, Tq))
    for q0 in range(0, Tq, tatt.BLOCK):
        qb = q[:, q0:q0 + tatt.BLOCK]
        bq = qb.shape[1]
        m = torch.full((BH, bq), -1e30)
        l = torch.zeros((BH, bq))
        acc = torch.zeros((BH, bq, D))
        for k0 in range(0, Tk, tatt.BLOCK):
            if causal and k0 > q0 + tatt.BLOCK - 1:
                break
            kb, vb = k[:, k0:k0 + tatt.BLOCK], v[:, k0:k0 + tatt.BLOCK]
            s = bmm(qb, kb.transpose(1, 2).contiguous()) * scale
            ok = mask[:, None, k0:k0 + tatt.BLOCK] != 0
            if causal:
                ok = ok & (k0 + torch.arange(kb.shape[1])[None, :]
                           <= q0 + torch.arange(bq)[:, None])
            s = torch.where(ok, s, -1e30)
            new_m = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(s <= -5e29, 0.0, torch.exp(s - new_m[..., None]))
            alpha = torch.exp(m - new_m)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + bmm(p, vb)
            m = new_m
        safe_l = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + bq] = acc / safe_l[..., None]
        lse[:, q0:q0 + bq] = m + torch.log(safe_l)
    return out, lse


def _unit_normal_case(with_mask, seed=7, BH=48, T=128, D=64):
    rs = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rs.normal(size=(BH, T, D)).astype(np.float32))
               for _ in range(3))
    mask = np.ones((BH, T), np.int32)
    if with_mask:  # padding: each row attends to its first 1..T keys
        mask = (np.arange(T)[None, :] < rs.integers(1, T + 1, BH)[:, None]).astype(np.int32)
    return q, k, v, torch.from_numpy(mask)


def test_tf32_emulation_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 2 - ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2.0, 3.0, 0.0]
    assert _tf32(x).tolist() == want
    assert _tf32_truncated(x).tolist() == [1.0, -1.0, 1.0, 1 + ulp, 2 - ulp, 3.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = _tf32(y)
    lo = _tf32_truncated(y - hi)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((y - hi).abs() <= hi.abs() * 2.0 ** -11).all()
    assert ((y - hi - lo).abs() <= hi.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_split_tf32_flash_within_f32_tolerance(with_mask, causal):
    """Three TF32 products a step keep the kernel within the f32 path's
    tolerances (2e-5 on O, 1e-4 on the LSE) of its plain version."""
    q, k, v, mask = _unit_normal_case(with_mask)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want_out, want_lse = tatt.flash_attention_fwd_plain(q, k, v, mask, causal, scale)
    got_out, got_lse = _flash_with(_bmm_split_tf32, q, k, v, mask, causal, scale)
    assert float((got_out - want_out).abs().max()) <= 2e-5
    assert float((got_lse - want_lse).abs().max()) <= 1e-4


def test_single_tf32_flash_misses_f32_tolerance():
    """One TF32 product a step misses 2e-5 on O: why the kernel takes three."""
    q, k, v, mask = _unit_normal_case(with_mask=True)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want_out, _ = tatt.flash_attention_fwd_plain(q, k, v, mask, False, scale)
    single, _ = _flash_with(_bmm_single_tf32, q, k, v, mask, False, scale)
    split, _ = _flash_with(_bmm_split_tf32, q, k, v, mask, False, scale)
    single_err = float((single - want_out).abs().max())
    split_err = float((split - want_out).abs().max())
    assert single_err > 2e-5 and split_err < single_err / 10
