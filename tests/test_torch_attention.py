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
    q, k, v, _ = make_qkv(T=8)
    before = dict(tatt.flash_attention_fwd.launches)
    tatt.flash_attention(*_t(q, k, v))
    assert tatt.flash_attention_fwd.launches == before
    qg = torch.from_numpy(q).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        tatt.flash_attention(qg, *_t(k, v))


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
        tatt._kernel_args(q, k, k, mask, torch.empty_like(k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_args_dims_and_strides(dtype):
    """The C call's dims and strides for projection views: no copy, the
    views' own strides; misaligned or D-strided tensors are refused."""
    B, T, H, D = 2, 50, 3, 32
    q, k, v = _projection_views(B, T, H, D, dtype)
    out = torch.empty((B, T, H, D), dtype=dtype)
    mask = torch.ones(B, T, dtype=torch.int32)
    args = tatt._kernel_args(q, k, v, mask, out)
    view = (T * 3 * H * D, 3 * H * D, D)
    assert args == (B, H, T, T, D, *view, *view, *view, T * H * D, H * D, D)
    # [BH, T, D] as [B=BH, T, 1, D]: a size-1 head dim passes stride 0
    flat = torch.zeros(6, T, D, dtype=dtype)
    args = tatt._kernel_args(*(flat.unsqueeze(2),) * 3, torch.ones(6, T, dtype=torch.int32),
                             torch.empty_like(flat).unsqueeze(2))
    assert args == (6, 1, T, T, D) + (T * D, D, 0) * 4
    # one element off the 16-byte grid
    shifted = torch.zeros(B * T * H * D + 1, dtype=dtype)[1:].view(B, T, H, D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt._kernel_args(shifted, k, v, mask, out)
    # a token stride that is not a multiple of 16 bytes
    odd = torch.zeros(B, T, H * D + 2, dtype=dtype)[..., :H * D].unflatten(-1, (H, D))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt._kernel_args(q, odd, v, mask, out)
    d_strided = torch.zeros(B, T, D, H, dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError, match="innermost"):
        tatt._kernel_args(q, k, d_strided, mask, out)


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
