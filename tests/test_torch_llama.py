"""synapseml_torch's Llama nets against the JAX package's flax_nets.llama.

Both sides run the same weights: the Flax init of ``llama_tiny`` (GQA 4/2)
plus seeded noise, bridged by ``convert_jax.llama_state_dict_from_flax``.
f32 logits of ``LlamaLM`` (with and without ``learned_pos``) and of the
paged functions agree within 1e-5, the live pages too; greedy tokens are
identical; bf16 logits stay within test_ops.py's bf16 limit (3e-2).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.hf.causal_lm import load_llama
from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import llama as tl
from synapseml_torch.models.nets import transformer as tt
from synapseml_tpu.models.flax_nets import llama as jl
from synapseml_tpu.models.flax_nets import transformer as jt

TOL = 1e-5
TOL_BF16 = 3e-2  # tests/test_ops.py's bf16 limit


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(jcfg, seed=0):
    init = jax.jit(jl.LlamaLM(jcfg).init)
    params = nn.unbox(init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    rs = np.random.default_rng(seed + 1)
    # noise on every leaf, so zero biases and unit scales are exercised too
    return jax.tree.map(lambda a: np.asarray(a) + rs.standard_normal(a.shape).astype(
        np.float32) * np.float32(0.02), params)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, Flax params, port model) of llama_tiny in f32."""
    jcfg = jl.llama_tiny(dtype=jnp.float32)
    params = _flax_params(jcfg)
    model = load_llama(tl.llama_tiny(dtype=torch.float32),
                       convert_jax.llama_state_dict_from_flax(params), "cpu")
    return jcfg, params, model


def _padded(lens, P, seed, vocab=256):
    rs = np.random.default_rng(seed)
    ids = np.zeros((len(lens), P), np.int32)
    mask = np.zeros((len(lens), P), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.integers(2, vocab, n)
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("learned_pos", [False, True])
def test_logits_match_jax(learned_pos):
    jcfg = jl.llama_tiny(dtype=jnp.float32, learned_pos=learned_pos)
    params = _flax_params(jcfg, seed=3)
    model = load_llama(tl.llama_tiny(dtype=torch.float32, learned_pos=learned_pos),
                       convert_jax.llama_state_dict_from_flax(params), "cpu")
    ids, mask = _padded([20, 13, 7], 20, seed=4)
    want = jax.jit(lambda i, m: jl.LlamaLM(jcfg).apply({"params": params}, i,
                                                       attention_mask=m))(ids, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], atol=TOL, rtol=0)


def test_bf16_logits_within_the_bf16_limit(tiny):
    _, params, _ = tiny
    jcfg = jl.llama_tiny()  # bf16 compute, f32 params
    model = load_llama(tl.llama_tiny(), convert_jax.llama_state_dict_from_flax(params), "cpu")
    ids, mask = _padded([16, 9], 16, seed=5)
    want = np.asarray(jax.jit(lambda i, m: jl.LlamaLM(jcfg).apply(
        {"params": params}, i, attention_mask=m))(ids, mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32  # the lm_head runs in f32
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=TOL_BF16, rtol=0)


def test_rope_and_offset_causal_mask_match_jax():
    """The port's rotation (``apply_rope`` over ``rope_tables``, the path
    ``Attention.project`` runs) against JAX's ``apply_rope`` over its
    tables, in f32 and bf16, and as ``project`` applies it to q and k."""
    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rs.integers(0, 64, (2, 5)).astype(np.int32)
    cos, sin = jt.rope_frequencies(16, 64, 10000.0)
    tcos, tsin = tt.rope_frequencies(16, 64, 10000.0)
    np.testing.assert_array_equal(tcos, cos)
    np.testing.assert_array_equal(tsin, sin)
    fcos, fsin = tt.rope_tables(16, 64, 10000.0, "cpu")
    want = jt.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(pos))
    got = tt.apply_rope(torch.from_numpy(x), fcos, fsin, torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # bf16 in, bf16 out: the products run in f32 against the f32 tables
    xb = torch.from_numpy(x).bfloat16()
    wb = jt.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(cos),
                       jnp.asarray(sin), jnp.asarray(pos))
    gb = tt.apply_rope(xb, fcos, fsin, torch.from_numpy(pos).long())
    assert gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.float().numpy(), np.asarray(wb, dtype=np.float32))
    # Attention.project: q and k rotated at the given positions, v not
    cfg = tt.TransformerConfig(vocab_size=8, hidden=32, n_heads=4, n_kv_heads=2, mlp_dim=32,
                               n_layers=1, max_len=64, dtype=torch.float32, causal=True,
                               use_rope=True)
    attn = tt.Attention(cfg)
    h = torch.from_numpy(rs.standard_normal((2, 5, 32)).astype(np.float32))
    with torch.no_grad():
        q, k, v = attn.project(h, torch.from_numpy(pos).long())
        q0 = tt.dense(attn.q, h, cfg.dtype).view(2, 5, 4, 8).numpy()
        k0 = tt.dense(attn.k, h, cfg.dtype).view(2, 5, 2, 8).numpy()
        v0 = tt.dense(attn.v, h, cfg.dtype).view(2, 5, 2, 8).numpy()
    jcos, jsin = jt.rope_frequencies(8, 64, 10000.0)
    for a, a0 in ((q, q0), (k, k0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(jt.apply_rope(
            jnp.asarray(a0), jnp.asarray(jcos), jnp.asarray(jsin), jnp.asarray(pos))),
            atol=1e-6, rtol=0)
    np.testing.assert_array_equal(v.numpy(), v0)
    for q, kv, off in ((1, 8, 5), (3, 8, 2), (4, 4, 0)):
        np.testing.assert_array_equal(tt.make_causal_mask(q, kv, offset=off).numpy(),
                                      np.asarray(jt.make_causal_mask(q, kv, offset=off)))


def test_greedy_generate_matches_jax(tiny):
    """Right-padded prompts over three prompt rungs, with and without an
    eos_id that fires for some rows: the JAX tokens exactly."""
    jcfg, params, model = tiny
    runs = {}
    for P, lens in ((8, [5, 8]), (16, [9, 16, 3]), (32, [27, 12])):
        ids, mask = _padded(lens, P, seed=P)
        runs[P] = (ids, mask)
        fn = jax.jit(lambda i, m: jl.greedy_generate(
            jl.LlamaLM(jcfg, decode=True), params, i, 12, prompt_mask=m))
        want = np.asarray(fn(ids, mask))
        got = tl.greedy_generate(model, ids, 12, prompt_mask=mask).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    ids, mask = runs[16]
    free = tl.greedy_generate(model, ids, 12, prompt_mask=mask).numpy()[:, 16:]
    eos = int(free[0, 3])  # fires mid-stream in row 0
    want = np.asarray(jax.jit(lambda i, m: jl.greedy_generate(
        jl.LlamaLM(jcfg, decode=True), params, i, 12, eos_id=eos, prompt_mask=m))(ids, mask))
    got = tl.greedy_generate(model, ids, 12, eos_id=eos, prompt_mask=mask).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 16 + 4:] == eos).all()


def test_generate_refuses_past_max_len(tiny):
    _, _, model = tiny
    with pytest.raises(ValueError, match="max_len"):
        tl.generate(model, np.zeros((1, 120), np.int32), 9)


def test_kv_cache_is_explicit_state(tiny):
    """A decode call writes its K/V at ``cache.index`` (head-major) and
    returns the cache advanced; logits of prefill + one step equal the
    no-cache forward over the same tokens."""
    _, _, model = tiny
    cfg = model.cfg
    ids, _ = _padded([10], 10, seed=9)
    ids = torch.from_numpy(ids).long()
    cache = tt.KVCache.zeros(cfg, 1, "cpu")
    assert cache.k[0].shape == (1, cfg.kv_heads, cfg.max_len, cfg.head_dim)
    with torch.no_grad():
        full = model(ids)
        pre, c1 = model(ids[:, :9], cache=cache)
        step, c2 = model(ids[:, 9:], positions=torch.tensor([[9]]), cache=c1)
    assert (c1.index, c2.index) == (9, 10) and c2.k[0] is cache.k[0]
    assert cache.k[0][:, :, 10:].abs().max() == 0 and cache.k[0][:, :, 9].abs().max() > 0
    np.testing.assert_allclose(pre.numpy(), full[:, :9].numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(step.numpy(), full[:, 9:].numpy(), atol=TOL, rtol=0)


def _jax_pages(jcfg, n_blocks, bl, seed):
    rs = np.random.default_rng(seed)
    shape = (n_blocks, bl, jcfg.kv_heads, jcfg.head_dim)
    return tuple(rs.standard_normal(shape).astype(np.float32) for _ in range(jcfg.n_layers))


def test_paged_functions_match_jax(tiny):
    """paged_prefill, then paged_extend, paged_decode_step and paged_verify
    on the same pool: logits within 1e-5 of JAX after each, and every page
    but the trash page equal."""
    jcfg, params, model = tiny
    bl, n_blocks, max_blocks = 8, 12, 5
    kp, vp = _jax_pages(jcfg, n_blocks, bl, 0), _jax_pages(jcfg, n_blocks, bl, 1)
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    tables = np.zeros((3, max_blocks), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [2, 9]
    tables[2, :4] = [4, 5, 6, 8]
    T = lambda a: torch.from_numpy(np.asarray(a)).long()  # noqa: E731

    def check(got, want, pages):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        jk, jv = pages
        for a, b in zip(tk + tv, list(jk) + list(jv)):
            np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:], atol=TOL, rtol=0)

    ids, mask = _padded([13, 5, 16], 16, seed=2)
    want, kp, vp = jax.jit(lambda *a: jl.paged_prefill(jcfg, bl, params, *a))(
        ids, mask, tables, kp, vp)
    check(tl.paged_prefill(model, bl, T(ids), T(mask), T(tables), tk, tv), want, (kp, vp))

    sfx, smask = _padded([4, 2, 6], 8, seed=3)
    start = np.asarray([13, 5, 16], np.int32)
    want, kp, vp = jax.jit(lambda *a: jl.paged_extend(jcfg, bl, params, *a))(
        sfx, smask, start, tables, kp, vp)
    check(tl.paged_extend(model, bl, T(sfx), T(smask), T(start), T(tables), tk, tv), want,
          (kp, vp))

    tok = np.asarray([7, 11, 3], np.int32)
    lens = np.asarray([17, 7, 22], np.int32)
    active = np.asarray([True, False, True])
    want, kp, vp = jax.jit(lambda *a: jl.paged_decode_step(jcfg, bl, params, *a))(
        tok, lens, active, tables, kp, vp)
    check(tl.paged_decode_step(model, bl, T(tok), T(lens), T(active), T(tables), tk, tv),
          want, (kp, vp))

    win = np.asarray([[5, 6, 7], [8, 9, 10], [11, 12, 13]], np.int32)
    lens = np.asarray([18, 7, 23], np.int32)
    want, kp, vp = jax.jit(lambda *a: jl.paged_verify(jcfg, bl, params, *a))(
        win, lens, active, tables, kp, vp)
    check(tl.paged_verify(model, bl, T(win), T(lens), T(active), T(tables), tk, tv), want,
          (kp, vp))


def test_early_exit_model_shares_the_first_layers(tiny):
    _, _, model = tiny
    sub = tl.early_exit_model(model, 1)
    assert sub.cfg.n_layers == 1 and len(sub.decoder.layers) == 1
    assert sub.decoder.layers[0] is model.decoder.layers[0]
    assert sub.embed is model.embed and sub.lm_head is model.lm_head
    assert sub.decoder.norm is model.decoder.norm


def test_compute_weights_cast_once_is_the_per_call_cast():
    """load_llama casts the decoder's dense weights to the compute dtype in
    place: bitwise the per-call cast's logits; the embedding, the norms and
    the lm_head stay in the parameter dtype; the state_dict given keeps its
    own tensors; in f32 compute nothing is cast."""
    cfg = tl.llama_tiny()
    sd = convert_jax.init_llama_params(cfg, seed=4, device="cpu")
    with torch.device("meta"):
        plain = tl.LlamaLM(cfg)
    plain.load_state_dict(sd, assign=True)
    cast = load_llama(cfg, sd, "cpu")
    dtypes = {k: v.dtype for k, v in cast.state_dict().items()}
    for name, dtype in dtypes.items():
        linear = name.startswith("decoder.layers.") and (".attn." in name or ".mlp." in name)
        assert dtype == (torch.bfloat16 if linear else torch.float32), name
    assert all(v.dtype == torch.float32 for v in sd.values())
    ids = torch.from_numpy(_padded([12], 12, seed=1)[0]).long()
    with torch.no_grad():
        np.testing.assert_array_equal(cast(ids).numpy(), plain(ids).numpy())
    f32 = load_llama(dataclasses.replace(cfg, dtype=torch.float32), sd, "cpu")
    assert f32.decoder.layers[0].attn.q.weight.data_ptr() == \
        sd["decoder.layers.0.attn.q.weight"].data_ptr()


def test_state_dict_bridge_covers_the_module():
    jcfg = jl.llama_tiny(dtype=jnp.float32, learned_pos=True)
    params = _flax_params(jcfg)
    sd = convert_jax.llama_state_dict_from_flax(params)
    with torch.device("meta"):
        model = tl.LlamaLM(tl.llama_tiny(dtype=torch.float32, learned_pos=True))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == want
    with pytest.raises(KeyError):
        convert_jax.llama_state_dict_from_flax({**params, "pooler": {}})


def test_init_llama_params_has_the_flax_distribution():
    cfg = tl.llama_tiny(hidden=128, n_heads=4, n_kv_heads=2, mlp_dim=256, n_layers=2,
                        vocab_size=512)
    sd = convert_jax.init_llama_params(cfg, seed=0, device="cpu")
    again = convert_jax.init_llama_params(cfg, seed=0, device="cpu")
    other = convert_jax.init_llama_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["embed.weight"], other["embed.weight"])
    with torch.device("meta"):
        model = tl.LlamaLM(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    for name in ("embed.weight", "lm_head.weight"):
        w = sd[name]
        assert abs(w.mean().item()) < 2e-3 and abs(w.std().item() - 0.02) < 1e-3, name
    fans = {"attn.q": (128, 128), "attn.k": (128, 64), "attn.v": (128, 64),
            "attn.o": (128, 128), "mlp.gate": (128, 256), "mlp.up": (128, 256),
            "mlp.down": (256, 128)}
    for i in range(cfg.n_layers):
        for part, (fan_in, fan_out) in fans.items():
            w = sd[f"decoder.layers.{i}.{part}.weight"]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            assert w.shape == (fan_out, fan_in)
            assert w.abs().max().item() <= lim and w.abs().max().item() > 0.95 * lim
            # U(-lim, lim) has variance lim^2 / 3
            assert abs(w.var().item() / (lim * lim / 3) - 1) < 0.1, part
            assert not sd[f"decoder.layers.{i}.{part}.bias"].any()
        for norm in ("norm1", "norm2"):
            assert (sd[f"decoder.layers.{i}.{norm}.weight"] == 1).all()
    assert (sd["decoder.norm.weight"] == 1).all()
    assert all(v.dtype == torch.float32 for v in sd.values())
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert_jax.init_llama_params(cfg, seed=0)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_logits_match_jax(dispatch):
    """llama_tiny with MoE layers (4 experts, top-2, SwiGLU experts; the
    scatter case dropless as a Mixtral directory maps it): f32 logits within
    1e-5 of the JAX LlamaLM on the same weights."""
    moe = dict(moe_experts=4, moe_top_k=2, moe_dispatch=dispatch,
               moe_capacity_factor=2.0 if dispatch == "scatter" else 1.25)
    jcfg = jl.llama_tiny(dtype=jnp.float32, **moe)
    params = _flax_params(jcfg, seed=5)
    model = load_llama(tl.llama_tiny(dtype=torch.float32, **moe),
                       convert_jax.llama_state_dict_from_flax(params), "cpu")
    assert isinstance(model.decoder.layers[0].mlp, tt.MoEBlock)
    ids, mask = _padded([20, 13, 7], 20, seed=6)
    want = jax.jit(lambda i, m: jl.LlamaLM(jcfg).apply({"params": params}, i,
                                                       attention_mask=m))(ids, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], atol=TOL, rtol=0)


def test_init_llama_params_moe_has_the_flax_distribution():
    """MoE layers of init_llama_params and of the numpy Flax-layout draw
    (convert_jax._flax_encoder, the text stages' init): the router
    Xavier-uniform over (hidden, E), each expert kernel over Flax's fans
    with the expert axis a receptive field, sqrt(6 / (E*in + E*out)) —
    the limit a jax xavier_uniform draw reaches — expert biases 0, routers
    and experts in f32."""
    E, hid, mlp = 8, 64, 256
    lim = np.sqrt(6.0 / (E * hid + E * mlp))
    assert abs(lim - 0.04841) < 1e-5
    jdraw = np.asarray(jax.nn.initializers.xavier_uniform()(jax.random.PRNGKey(0),
                                                            (E, hid, mlp)))
    assert lim * 0.99 < np.abs(jdraw).max() <= lim
    cfg = tl.llama_tiny(hidden=hid, mlp_dim=mlp, moe_experts=E, moe_top_k=2)
    sd = convert_jax.init_llama_params(cfg, seed=0, device="cpu")
    enc = convert_jax._flax_encoder(cfg, np.random.default_rng(0))
    for i in range(cfg.n_layers):
        pre = f"decoder.layers.{i}.mlp"
        flax = enc[f"layer_{i}"]["mlp"]
        cases = [(sd[f"{pre}.router.weight"].numpy().T, flax["router"]["kernel"],
                  np.sqrt(6.0 / (hid + E)))]
        for name, shape in (("w_gate", (E, hid, mlp)), ("w_up", (E, hid, mlp)),
                            ("w_dn", (E, mlp, hid))):
            cases.append((sd[f"{pre}.{name}"].numpy(), flax[name], lim))
            assert sd[f"{pre}.{name}"].shape == flax[name].shape == shape, name
        for got_t, got_f, bound in cases:
            for w in (got_t, got_f):
                assert w.dtype == np.float32
                assert bound * 0.95 < np.abs(w).max() <= bound
                # U(-b, b) has variance b^2 / 3; its sample variance has a
                # relative spread of sqrt(0.8 / n)
                assert abs(w.var() / (bound * bound / 3) - 1) < 4 * np.sqrt(0.8 / w.size)
        for name in ("b_up", "b_dn"):
            assert not sd[f"{pre}.{name}"].any() and not flax[name].any()
    with torch.device("meta"):
        model = tl.LlamaLM(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_paged_modules_refuse_non_llama_configs():
    with torch.device("meta"):
        m = tl.LlamaLM(tl.llama_tiny(learned_pos=True))
    with pytest.raises(ValueError, match="Llama family"):
        tl.PagedLlamaLM(m, 8)
