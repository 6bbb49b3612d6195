"""The flash-attention backward of synapseml_torch against synapseml_tpu's.

The same numpy inputs go through ``jax.grad`` of the JAX package's
``flash_attention`` (the Pallas forward in interpret mode on the CPU, as
tests/test_ops.py runs it, and its XLA backward ``_flash_core_bwd``) and
through the port: autograd through ``flash_attention``, whose CPU tensors
take the backward kernel's plain version ``flash_attention_bwd_plain``, and
that plain version called directly. Tolerances are those of
tests/test_ops.py:30-68: f32 atol 5e-5 (the two sum in different orders);
bf16 against the f32 oracle atol 0.15, rtol 0.05. Fully masked rows and
padded keys get exactly zero gradient, and a CPU call launches no kernel.
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.ops import _build
from synapseml_torch.ops import attention as tatt
from synapseml_tpu.ops import attention as jatt


def make_qkv(B=2, T=64, H=4, D=32, seed=0):
    rs = np.random.default_rng(seed)
    q, k, v = (rs.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = rs.random((B, T)) > 0.2
    return q, k, v, mask


def jax_grads(q, k, v, mask, causal, fn=None):
    """``jax.grad`` of ``sum(out ** 2)`` through the JAX flash_attention
    (16-row blocks, as tests/test_ops.py), or through ``fn``."""
    fn = fn or (lambda *a, **kw: jatt.flash_attention(*a, block_q=16, block_k=16, **kw))
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, kv_mask=jmask, causal=causal).astype(jnp.float32) ** 2)

    return [np.asarray(g, dtype=np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


def port_grads(q, k, v, mask, causal, dtype=torch.float32, fn=None):
    """Autograd of ``sum(out ** 2)`` through the port's flash_attention."""
    fn = fn or tatt.flash_attention
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, None if mask is None else torch.from_numpy(mask), causal=causal)
    (out.float() ** 2).sum().backward()
    return [x.grad for x in leaves]


def _bh(x):
    """[B, T, H, D] numpy -> a [B*H, T, D] tensor."""
    B, T, H, D = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, T, D)))


def _bthd(x, B, H):
    BH, T, D = x.shape
    return x.reshape(B, H, T, D).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_autograd_matches_jax_grad(causal, with_mask):
    q, k, v, mask = make_qkv()
    mask = mask if with_mask else None
    want = jax_grads(q, k, v, mask, causal)
    got = port_grads(q, k, v, mask, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax_grad(causal):
    """``flash_attention_bwd_plain`` on [B*H, T, D] with the forward's out
    and LSE and dout = 2 * out (the gradient of sum(out ** 2))."""
    B, T, H, D = 2, 64, 4, 32
    q, k, v, mask = make_qkv(B, T, H, D, seed=1)
    want = jax_grads(q, k, v, mask, causal)
    bmask = torch.from_numpy(np.repeat(mask, H, axis=0).astype(np.int32))
    qb, kb, vb = _bh(q), _bh(k), _bh(v)
    scale = 1.0 / np.sqrt(D)
    out, lse = tatt.flash_attention_fwd_plain(qb, kb, vb, bmask, causal, scale)
    got = tatt.flash_attention_bwd_plain(qb, kb, vb, bmask, out, lse, 2 * out, causal, scale)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_bthd(g, B, H), w, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("T,D,causal", [(50, 32, True), (50, 32, False), (50, 40, True),
                                        (130, 24, False)])
def test_unaligned_shapes_match_jax_grad(T, D, causal):
    """T not a multiple of the 64-row tile, D = 40 and 24 zero-padded to the
    kernel's 64 and 32 (the pad stays differentiable), B*H > 1."""
    q, k, v, mask = make_qkv(B=2, T=T, H=3, D=D, seed=2)
    want = jax_grads(q, k, v, mask, causal)
    got = port_grads(q, k, v, mask, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (2, T, 3, D)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_reference_attention(causal):
    """Against autograd through the port's own reference_attention (f32),
    with no fully masked row (where the two paths differ by design)."""
    q, k, v, mask = make_qkv(T=40, seed=3)
    mask[:, 0] = True
    want = port_grads(q, k, v, mask, causal, fn=tatt.reference_attention)
    got = port_grads(q, k, v, mask, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-5, err_msg=f"d{name}")


def test_bf16_grads_match_f32_oracle():
    """bf16 q, k, v through the port against jax.grad of the f32 reference,
    as tests/test_ops.py::test_flash_bf16_matches_f32_reference holds the
    JAX package's bf16 flash gradients."""
    q, k, v, mask = make_qkv(T=16, seed=4)
    want = jax_grads(q, k, v, mask, True, fn=jatt.reference_attention)
    got = port_grads(q, k, v, mask, True, dtype=torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=0.15, rtol=0.05,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_rows_and_padded_keys_get_exactly_zero(dtype):
    """Batch row 0 has every key masked (every query row fully masked);
    batch row 1 masks its first 10 keys and, causal, its first 10 query
    rows see no key. Their dq, and dk and dv at masked keys, are exactly 0;
    the output there is 0 too."""
    q, k, v, _ = make_qkv(B=2, T=70, H=2, D=32, seed=5)
    mask = np.ones((2, 70), bool)
    mask[0] = False
    mask[1, :10] = False
    mask[1, 60:] = False
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, torch.from_numpy(mask), causal=True)
    dout = torch.from_numpy(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
    out.backward(dout.to(dtype))
    dq, dk, dv = (x.grad for x in leaves)
    out = out.detach()
    assert float(out[0].abs().max()) == 0.0 and float(out[1, :10].abs().max()) == 0.0
    assert float(dq[0].abs().max()) == 0.0 and float(dq[1, :10].abs().max()) == 0.0
    for g in (dk, dv):
        assert float(g[0].abs().max()) == 0.0
        assert float(g[1, :10].abs().max()) == 0.0 and float(g[1, 60:].abs().max()) == 0.0
    assert float(dq[1, 10:].abs().max()) > 0 and float(dv[1, 10:60].abs().max()) > 0


def test_strided_projection_views_differentiate():
    """q, k, v as [B, T, H, D] views of one projection: the gradient reaches
    the projection, equal to the one through contiguous copies."""
    rs = np.random.default_rng(6)
    B, T, H, D = 2, 50, 3, 32
    proj = torch.from_numpy(rs.normal(size=(B, T, 3 * H * D)).astype(np.float32))
    mask = torch.from_numpy(rs.random((B, T)) > 0.25)
    dout = torch.from_numpy(rs.normal(size=(B, T, H, D)).astype(np.float32))
    grads = []
    for copy in (False, True):
        p = proj.clone().requires_grad_()
        q, k, v = (x.unflatten(-1, (H, D)) for x in p.split(H * D, dim=-1))
        if copy:
            q, k, v = (x.contiguous() for x in (q, k, v))
        else:
            assert not q.is_contiguous()
        tatt.flash_attention(q, k, v, mask).backward(dout)
        grads.append(p.grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0


def _chip_smoke():
    """chip_smoke.py at the repo root, imported as a module (its checks run
    only from main())."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chip_check_bwd_limit_passes_reordering_and_fails_planted_faults(dtype, block,
                                                                          monkeypatch):
    """The chip check holds the backward kernel to its plain version with
    ``_bwd_err`` under ``TOL_BWD``. At a BERT-base head (T = 128, D = 64) with
    padding lengths down to 1 and fully masked rows, the limit must pass the
    plain version blocked at ``block`` instead of 64 (the same function summed
    in another order: at 128, the bf16 kernel's kv tile, dq is summed over
    fewer, larger tiles, as that kernel sums it), with room to spare, and must
    fail a plain version that drops delta or whose dq, dk or dv is 5 % off."""
    cs = _chip_smoke()
    tol = cs.TOL_BWD[dtype]
    BH, T, D = 48, 128, 64
    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(BH, T, D, generator=g).to(dtype) for _ in range(4))
    mask = cs._padding_mask(BH, T, "cpu", seed=7, empty_rows=4)
    scale = 1.0 / D ** 0.5
    out, lse = tatt.flash_attention_fwd_plain(q, k, v, mask, False, scale)
    want = tatt.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, False, scale)
    monkeypatch.setattr(tatt, "BLOCK", block)
    reordered = tatt.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, False, scale)
    monkeypatch.undo()
    assert not all(torch.equal(a, b) for a, b in zip(reordered, want))
    assert cs._bwd_err(reordered, want) <= tol / 2
    no_delta = tatt.flash_attention_bwd_plain(q, k, v, mask, torch.zeros_like(out), lse, dout,
                                              False, scale)
    assert cs._bwd_err(no_delta, want) > 100 * tol
    for i in range(3):
        off = [x * 1.05 if j == i else x for j, x in enumerate(want)]
        assert cs._bwd_err(off, want) > 3 * tol


def test_cpu_path_launches_no_kernel():
    q, k, v, mask = make_qkv(T=8)
    fwd, bwd = dict(tatt.flash_attention_fwd.launches), dict(tatt.flash_attention_bwd.launches)
    port_grads(q, k, v, mask, False)
    port_grads(q, k, v, mask, True, dtype=torch.bfloat16)
    qb = _bh(q)
    m = torch.ones(qb.shape[:2], dtype=torch.int32)
    out, lse = tatt.flash_attention_fwd(qb, qb, qb, m)
    tatt.flash_attention_bwd(qb, qb, qb, m, out, lse, out)
    assert tatt.flash_attention_fwd.launches == fwd
    assert tatt.flash_attention_bwd.launches == bwd


def test_inference_path_builds_no_graph():
    """Without grad (as scoring runs) flash_attention runs the forward alone:
    no autograd node, even for inputs that require grad."""
    q, k, v, mask = make_qkv(T=8)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = tatt.flash_attention(*leaves, torch.from_numpy(mask))
    assert out.grad_fn is None and not out.requires_grad
    out = tatt.flash_attention(*leaves, torch.from_numpy(mask))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad,err,match", [
    ("dout_shape", ValueError,
     r"flash_attention_bwd: want q, out and dout .* dout \(2, 8, 2, 64\)"),
    ("dout_dtype", TypeError, "flash_attention_bwd: .*float32 or bfloat16"),
    ("dout_strided", ValueError, "flash_attention_bwd: dout must have D innermost"),
])
def test_kernel_argument_checks_cover_dout(bad, err, match, dtype):
    """What the CUDA wrapper refuses in dout before any launch, in the
    backward's name, for either kernel's dtype (checked on CPU tensors; the
    kernel itself runs only on the card)."""
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    q = torch.zeros(2, 16, 2, 64, dtype=dtype)
    mask = torch.ones(2, 16, dtype=torch.int32)
    dout = torch.zeros(2, 16, 2, 64, dtype=dtype)
    if bad == "dout_shape":
        dout = torch.zeros(2, 8, 2, 64, dtype=dtype)
    elif bad == "dout_dtype":
        dout = dout.to(other)
    elif bad == "dout_strided":
        dout = torch.zeros(2, 16, 64, 2, dtype=dtype).transpose(2, 3)
    with pytest.raises(err, match=match):
        tatt._kernel_args(q, q, q, mask, torch.empty_like(q), dout, fn="flash_attention_bwd")
    args = tatt._kernel_args(q, q, q, mask, torch.empty_like(q), torch.zeros_like(q),
                             fn="flash_attention_bwd")
    assert args == (2, 2, 16, 16, 64) + (16 * 2 * 64, 2 * 64, 64) * 5


def _c_function(src: str, signature: str) -> str:
    """The body of the C++ function of ``src`` that starts with
    ``signature``, up to its closing brace at the start of a line."""
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_map_error_code_matches_the_kernel_source(dtype):
    """The wrapper tells a refused TMA tensor map from a CUDA error by the
    code flash_bwd_bf16.cu returns for it. Only the bf16 path builds tensor
    maps; the float32 kernel (flash_bwd_f32.cu) copies its tiles with
    cp.async and never returns the code."""
    src = (_build.CSRC / f"{tatt._BWD_SOURCES[dtype]}.cu").read_text()
    bf16_src = (_build.CSRC / "flash_bwd_bf16.cu").read_text()
    assert f"constexpr int ERR_TENSOR_MAP = {tatt._TENSOR_MAP_ERR};" in bf16_src
    run = _c_function(src, "int run_tf32(" if dtype == torch.float32 else "int run_bf16(")
    kernel = _c_function(src, "flash_bwd_tf32_kernel(" if dtype == torch.float32
                         else "flash_bwd_wgmma_kernel(")
    if dtype == torch.float32:
        assert "encode_view" not in run and "tma_" not in kernel and "cp_async" in kernel
    else:
        assert run.count("encode_view<D>") == 8 and "tma_load_4d" in kernel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_views_are_told_from_size_one_dims(dtype):
    """The bf16 wrapper copies a view with a zero stride on a dim longer
    than 1 before the kernel builds its TMA maps (which step by every
    stride): k and v of one head expanded over the heads, a dout broadcast
    over the batch. A zero stride on a dim of size 1 is never stepped and
    needs no copy. The float32 kernel (cp.async) takes such views as they
    are."""
    B, T, H, D = 2, 16, 4, 64
    kv = torch.zeros(B, T, 1, D, dtype=dtype)
    assert tatt._broadcast(kv.expand(B, T, H, D))
    assert tatt._broadcast(torch.zeros(1, T, H, D).expand(B, T, H, D))
    assert not tatt._broadcast(kv)
    assert not tatt._broadcast(torch.zeros(T, H, D).expand(1, T, H, D))
    assert not tatt._broadcast(torch.zeros(B, T, 3 * H * D)[..., :H * D].unflatten(-1, (H, D)))
    q = torch.zeros(B, T, H, D, dtype=dtype)
    views = (q, kv.expand(B, T, H, D), kv.expand(B, T, H, D), torch.zeros_like(q),
             torch.zeros(1, T, H, D, dtype=dtype).expand(B, T, H, D))
    got = tatt._kernel_views(*views)
    copied = [a is not b for a, b in zip(got, views)]
    assert copied == ([False] * 5 if dtype == torch.float32 else [False, True, True, False, True])
    assert all(not tatt._broadcast(x) for x in got) or dtype == torch.float32


def test_trace_stamp_points_are_in_the_kernel_source():
    """scripts/flash_bwd_trace.py splices its timestamps into a copy of
    flash_bwd_bf16.cu at literal markers: each must still be there, once."""
    spec = importlib.util.spec_from_file_location(
        "flash_bwd_trace",
        pathlib.Path(__file__).resolve().parents[1] / "scripts" / "flash_bwd_trace.py")
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    src = (_build.CSRC / "flash_bwd_bf16.cu").read_text()
    for marker, _, _ in trace.POINTS:
        assert src.count(marker) == 1, marker


def test_non_cpu_tensors_launch_or_raise(monkeypatch, tmp_path):
    """No fallback hides the device: a tensor off the CPU goes to the kernel
    or raises. Meta tensors have no kernel; and on a host without nvcc the
    kernel cannot be built, so its entry point raises."""
    q = torch.empty(1, 8, 1, 32, device="meta")
    mask = torch.ones(1, 8, dtype=torch.int32, device="meta")
    lse = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tatt._flash_bwd_bthd(q, q, q, mask, q, lse, q, False, 1.0)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    for dtype in (torch.float32, torch.bfloat16):
        assert not os.path.exists(_build._lib_path(tatt._BWD_SOURCES[dtype]))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tatt._bwd_entry_point(dtype)


# --- the f32 kernel's split TF32, emulated -----------------------------------
# flash_bwd_tf32_kernel computes every product on the tensor cores, which
# read f32 as TF32 (10 mantissa bits). It splits each operand x into hi = x
# rounded to TF32 (as cvt.rna.tf32.f32) and lo = x - hi truncated to TF32,
# P and dS too where they become operands, and takes each product as
# a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32. delta = rowsum(O dO) is the
# diagonal of O dO^T taken in exactly dP's arithmetic, so that dP - delta,
# which is 0 for a query row that attends one key (its O is that key's V),
# is 0 in the kernel too. The emulation below (a copy of
# test_torch_attention.py's TF32 rounding; here only, no part of the port)
# holds that error budget, at the kernel's tiles, to the chip check's limit.

def _tf32(x):
    """``cvt.rna.tf32.f32``: x to 10 mantissa bits, to nearest, ties away from
    zero. f32 is sign and magnitude, so adding half of the 13 dropped bits'
    range to the bit pattern and clearing them rounds the magnitude."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_parts(x, single):
    """(hi, lo) of split TF32, or (x rounded to TF32, 0) for one pass."""
    hi = _tf32(x)
    return hi, torch.zeros_like(x) if single else _tf32_truncated(x - hi)


def _bmm_tf32(a, b, single=False):
    """a @ b as the kernel's mma steps: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    (ah, al), (bh, bl) = _tf32_parts(a, single), _tf32_parts(b, single)
    return torch.bmm(al, bh) + torch.bmm(ah, bl) + torch.bmm(ah, bh)


def _rows_tf32(a, b, single=False):
    """``[BH, m, D] x [BH, n, D] -> [BH, m, n]`` dot products of rows, in the
    same split and in one fixed order for every pair of rows, so that equal
    rows give equal bits (as one mma instruction does wherever they sit)."""
    (ah, al), (bh, bl) = _tf32_parts(a, single), _tf32_parts(b, single)

    def dot(x, y):
        return (x[:, :, None, :] * y[:, None, :, :]).sum(-1)

    return dot(al, bh) + dot(ah, bl) + dot(ah, bh)


def _bwd_split_tf32(q, k, v, mask, out, lse, dout, causal, scale, single=False, bn=128,
                    bm=64):
    """flash_attention_bwd_plain's function with flash_bwd_tf32_kernel's
    tiles (kv tiles of ``bn`` rows, q tiles of ``bm``; D = 64) and its
    arithmetic: S^T, dP^T and delta, then dV, dK and dQ, each product in
    split TF32 (``single``: one TF32 pass), dQ summed over the kv tiles in
    kv order."""
    Tq, Tk = q.shape[1], k.shape[1]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, Tq, bm):
        qb, gb = q[:, q0:q0 + bm], dout[:, q0:q0 + bm]
        delta = torch.diagonal(_rows_tf32(out[:, q0:q0 + bm], gb, single), dim1=1, dim2=2)
        for k0 in range(0, Tk, bn):
            if causal and k0 > q0 + bm - 1:
                continue
            kb, vb = k[:, k0:k0 + bn], v[:, k0:k0 + bn]
            st = _bmm_tf32(kb, qb.transpose(1, 2), single)
            dpt = _rows_tf32(vb, gb, single)
            ok = mask[:, k0:k0 + bn, None] != 0
            if causal:
                ok = ok & (k0 + torch.arange(kb.shape[1])[:, None]
                           <= q0 + torch.arange(qb.shape[1])[None, :])
            p = torch.where(ok, torch.exp(st * scale - lse[:, None, q0:q0 + bm]), 0.0)
            ds = p * (dpt - delta[:, None, :])
            dv[:, k0:k0 + bn] += _bmm_tf32(p, gb, single)
            dk[:, k0:k0 + bn] += _bmm_tf32(ds, qb, single)
            dq[:, q0:q0 + bm] = dq[:, q0:q0 + bm] + _bmm_tf32(ds.transpose(1, 2), kb, single)
    return dq * scale, dk * scale, dv


def _bwd_case_inputs(BH, T, causal, seed=7):
    """The chip check's inputs at D = 64 (those of the limit test above):
    padding lengths down to 1, four fully masked rows, random dout; the
    plain forward's out and LSE."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(BH, T, 64, generator=g) for _ in range(4))
    mask = cs._padding_mask(BH, T, "cpu", seed=seed, empty_rows=4)
    out, lse = tatt.flash_attention_fwd_plain(q, k, v, mask, causal, 1.0 / 8)
    return cs, (q, k, v, mask, out, lse, dout, causal, 1.0 / 8)


def _bwd_float64(q, k, v, mask, out, lse, dout, causal, scale):
    """The backward's function on the same inputs (the forward's out and
    LSE included) in float64, dense: (dq, dk, dv)."""
    q, k, v, out, lse, dout = (x.double() for x in (q, k, v, out, lse, dout))
    ok = (mask[:, None, :] != 0).expand(-1, q.shape[1], -1)
    if causal:
        ok = ok & (torch.arange(k.shape[1])[None, :] <= torch.arange(q.shape[1])[:, None])
    p = torch.where(ok, torch.exp(q @ k.transpose(1, 2) * scale - lse[..., None]), 0.0)
    ds = p * (dout @ v.transpose(1, 2) - (out * dout).sum(-1, keepdim=True))
    return ds @ k * scale, ds.transpose(1, 2) @ q * scale, p.transpose(1, 2) @ dout


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH,T", [(48, 128), (8, 512)])
def test_split_tf32_bwd_within_half_the_chip_limit(BH, T, causal):
    """The kernel's arithmetic, emulated, at a BERT-base head (T = 128) and
    at T = 512: within TOL_BWD / 2 by _bwd_err of the function in float64,
    and within TOL_BWD (the chip check) of the plain version. Not TOL_BWD / 2
    of the plain version: in a slice whose rows attend one key, dq and dk
    are 0 in exact arithmetic and the plain version's own rounding there is
    about 6e-5 of the floor at T = 128. The emulation gives those rows
    exactly zero dq and dk (dP - delta cancels), as exact arithmetic does."""
    cs, args = _bwd_case_inputs(BH, T, causal)
    got = _bwd_split_tf32(*args)
    tol = cs.TOL_BWD[torch.float32]
    assert cs._bwd_err(got, _bwd_float64(*args)) <= tol / 2
    assert cs._bwd_err(got, tatt.flash_attention_bwd_plain(*args)) <= tol
    mask = args[3]
    if causal:  # query row 0 attends key 0 alone in every slice that has it
        assert float(got[0][mask[:, 0] != 0, 0].abs().max()) == 0.0
    one_key = (mask.sum(1) == 1) & (mask[:, 0] != 0)
    if one_key.any():
        assert float(got[0][one_key].abs().max()) == 0.0
        assert float(got[1][one_key].abs().max()) == 0.0


def test_single_tf32_bwd_misses_the_chip_limit():
    """One TF32 pass a product misses TOL_BWD by far at the same inputs: why
    the kernel splits every operand."""
    cs, args = _bwd_case_inputs(48, 128, False)
    single = _bwd_split_tf32(*args, single=True)
    tol = cs.TOL_BWD[torch.float32]
    assert cs._bwd_err(single, _bwd_float64(*args)) > 5 * tol
    assert cs._bwd_err(single, tatt.flash_attention_bwd_plain(*args)) > 5 * tol
