"""synapseml_torch's MoEBlock and the trainer's switch aux loss against the
JAX package's.

The same parameters (the Flax init plus seeded noise, bridged by
``convert_jax``) and the same numpy inputs go through both ``MoEBlock``s,
for the ``einsum`` and ``scatter`` dispatches at top-1 and top-2, with
nothing dropped (capacity factor 8), under pressure (E = 2, cf 0.5) and at
a capacity of one token an expert (cf 1e-9): outputs within rtol 1e-5,
atol 1e-6, the aux loss within 1e-6. Routing and the dropped set are read
from both modules alike with probe weights (``w_dn`` 0, ``b_dn`` the
identity rows, so output column e of a token is the gate it kept for
expert e): the kept (token, expert) pairs are identical, the routed ones
are the top k of the router (ties to the lowest expert, as ``lax.top_k``:
the input holds a zero row), so the dropped ones are too. Also: the per-token
oracle of tests/test_moe.py, SwiGLU experts, bf16 compute within 3e-2,
gradients of the input and every parameter against ``jax.grad``, and
``bert_tiny`` MoE steps through both ``Trainer``s (the aux loss included)
to test_torch_trainer.py's tolerances.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.models import convert_jax
from synapseml_torch.models import trainer as ttr
from synapseml_torch.models.nets import bert as tbert
from synapseml_torch.models.nets import transformer as tt
from synapseml_tpu.models import trainer as jtr
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.models.flax_nets import transformer as jt
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

TOL_BF16 = 3e-2  # tests/test_ops.py's bf16 limit

_CAPACITY = {"none dropped": (4, 8.0), "pressure": (2, 0.5), "capacity 1": (2, 1e-9)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="f32", **kw):
    base = dict(hidden=16, n_layers=1, n_heads=4, mlp_dim=32, max_len=16, moe_experts=4,
                moe_capacity_factor=2.0)
    base.update(kw)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jt.TransformerConfig(dtype=jd, **base), tt.TransformerConfig(dtype=td, **base)


def _x(seed=0, shape=(2, 6, 16)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[0, 2] = 0.0  # a zero row: equal router probabilities, a tie at every choice
    return x


def _params(jcfg, seed=0):
    block = jt.MoEBlock(jcfg)
    p = nn.unbox(block.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, jcfg.hidden),
                                                                jcfg.dtype))["params"])
    rs = np.random.default_rng(seed + 1)
    # noise on every leaf, so the zero expert biases are exercised too
    return jax.tree.map(lambda a: np.asarray(a) + rs.standard_normal(a.shape).astype(
        np.float32) * np.float32(0.05), p)


def _state_dict(params: dict) -> dict:
    """A Flax MoEBlock's params -> the port's, through convert_jax's encoder
    map (a one-layer encoder around them)."""
    layer = {"attn": {p: {"kernel": np.zeros((1, 1, 1), np.float32)} for p in "qkvo"},
             "mlp": params, "LayerNorm_0": {"scale": np.ones(1)},
             "LayerNorm_1": {"scale": np.ones(1)}}
    out: dict = {}
    convert_jax._encoder_state(out, "e", {"layer_0": layer})
    pre = "e.layers.0.mlp."
    return {k[len(pre):]: torch.from_numpy(np.array(v)) for k, v in out.items()
            if k.startswith(pre)}


def _port(tcfg, params):
    m = tt.MoEBlock(tcfg)
    m.load_state_dict(_state_dict(params))
    return m


@functools.lru_cache(maxsize=None)
def _jax_fn(jcfg):
    return jax.jit(lambda p, v: jt.MoEBlock(jcfg).apply({"params": p}, v,
                                                        mutable=["intermediates"]))


def _jax_apply(jcfg, params, x):
    """(output, aux loss) of the JAX MoEBlock (one compile a config)."""
    y, state = _jax_fn(jcfg)(params, x)
    return np.asarray(y, np.float32), float(state["intermediates"]["moe_aux_loss"][0])


def _probe(params, E, H):
    """Probe weights: every expert outputs its one-hot row, so output column e
    of a token is the combine weight it kept for expert e."""
    p = dict(params)
    p["w_dn"] = np.zeros_like(params["w_dn"])
    p["b_dn"] = np.eye(E, H, dtype=np.float32)
    return p


@pytest.mark.parametrize("capacity", sorted(_CAPACITY))
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_block_matches_jax(dispatch, top_k, capacity):
    E, cf = _CAPACITY[capacity]
    jcfg, tcfg = _cfgs(moe_experts=E, moe_top_k=top_k, moe_capacity_factor=cf,
                       moe_dispatch=dispatch)
    params = _params(jcfg)
    x = _x()
    want, want_aux = _jax_apply(jcfg, params, x)
    m = _port(tcfg, params)
    got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.aux_loss.item(), want_aux, rtol=0, atol=1e-6)

    probe = _probe(params, E, 16)
    jkept, _ = _jax_apply(jcfg, probe, x)
    with torch.no_grad():
        tkept = _port(tcfg, probe)(torch.from_numpy(x)).numpy()
    jkept, tkept = jkept.reshape(-1, 16)[:, :E], tkept.reshape(-1, 16)[:, :E]
    assert np.array_equal(tkept != 0, jkept != 0), "the kept (token, expert) pairs differ"
    np.testing.assert_allclose(tkept, jkept, rtol=1e-5, atol=1e-7)
    # routed = the router's top k, ties to the lowest index (the zero row)
    probs = jax.nn.softmax(x.reshape(-1, 16) @ params["router"]["kernel"], axis=-1)
    routed = np.zeros((x.shape[0] * x.shape[1], E), bool)
    np.put_along_axis(routed, np.asarray(jax.lax.top_k(probs, top_k)[1]), True, axis=1)
    assert routed[2].tolist() == [e < top_k for e in range(E)]
    kept = tkept != 0
    assert not (kept & ~routed).any()
    dropped = routed & ~kept
    if capacity == "none dropped":
        assert not dropped.any()
    else:  # the same dropped set on both sides, and the layer did drop
        assert dropped.any() and np.array_equal(dropped, routed & (jkept == 0))
        C = max(int(np.ceil(cf * x.shape[0] * x.shape[1] * top_k / E)), 1)
        assert kept.sum(0).max() <= C


def _oracle(x, params, top_k):
    """tests/test_moe.py's per-token reference: route by top-k of the same
    router, apply the chosen experts densely (exact GELU), weight by the
    normalised gates; capacity ignored."""
    from scipy.special import erf

    xf = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    logits = xf @ params["router"]["kernel"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xf)
    for s in range(xf.shape[0]):
        idx = np.argsort(-probs[s], kind="stable")[:top_k]
        gates = probs[s][idx]
        gates = gates / gates.sum() if top_k > 1 else gates
        for e, g in zip(idx, gates):
            v = xf[s] @ params["w_up"][e].astype(np.float64) + params["b_up"][e]
            h = 0.5 * v * (1 + erf(v / np.sqrt(2)))
            out[s] += g * (h @ params["w_dn"][e].astype(np.float64) + params["b_dn"][e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_matches_per_token_oracle(dispatch, top_k):
    jcfg, tcfg = _cfgs(moe_top_k=top_k, moe_capacity_factor=8.0, moe_dispatch=dispatch)
    params = _params(jcfg, seed=3)
    x = _x(seed=4)
    with torch.no_grad():
        got = _port(tcfg, params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _oracle(x, params, top_k), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_swiglu_experts_match_jax(dispatch):
    """gated_mlp (Mixtral's expert): silu(x W_gate) * (x W_up + b_up)."""
    jcfg, tcfg = _cfgs(moe_top_k=2, moe_capacity_factor=1.0, moe_dispatch=dispatch,
                       gated_mlp=True, act="silu")
    params = _params(jcfg, seed=5)
    x = _x(seed=6, shape=(3, 5, 16))
    want, want_aux = _jax_apply(jcfg, params, x)
    m = _port(tcfg, params)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.aux_loss.item(), want_aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_bf16_compute_within_the_bf16_limit(dispatch):
    """bf16 activations and compute, f32 params: the router stays f32 on
    both sides, so the routing is the same and the outputs differ by bf16
    rounding only."""
    jcfg, tcfg = _cfgs("bf16", moe_top_k=2, moe_capacity_factor=1.0, moe_dispatch=dispatch,
                       gated_mlp=True, act="silu")
    params = _params(jcfg, seed=7)
    x = _x(seed=8)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = _jax_apply(jcfg, params, xb)
    m = _port(tcfg, params)
    assert m.router.weight.dtype == torch.float32
    with torch.no_grad():
        got = m(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL_BF16, rtol=0)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_gradients_match_jax_grad(dispatch):
    """Autograd through the port against jax.grad of the same loss (a random
    projection of the output plus 0.3 x the aux loss), with respect to the
    input and every parameter, under capacity pressure (drops included)."""
    jcfg, tcfg = _cfgs(moe_experts=4, moe_top_k=2, moe_capacity_factor=0.75,
                       moe_dispatch=dispatch, gated_mlp=True, act="silu")
    params = _params(jcfg, seed=9)
    x = _x(seed=10)
    r = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)

    def jloss(p, v):
        y, st = jt.MoEBlock(jcfg).apply({"params": p}, v, mutable=["intermediates"])
        return jnp.sum(y * r) + 0.3 * st["intermediates"]["moe_aux_loss"][0]

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, x)
    m = _port(tcfg, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.sum(m(xt) * torch.from_numpy(r)) + 0.3 * m.aux_loss).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-4, atol=1e-5)
    want = _state_dict(jax.tree.map(np.asarray, jg_p))
    grads = dict(m.named_parameters())
    assert sorted(grads) == sorted(want)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        assert p.grad.abs().sum() > 0, name


def test_moe_dispatch_validated():
    with pytest.raises(ValueError, match="moe_dispatch.*'scater'"):
        tt.MoEBlock(_cfgs(moe_dispatch="scater")[1])


def test_encoder_takes_moe_blocks_and_dense_ones_otherwise():
    _, tcfg = _cfgs(n_layers=2)
    enc = tt.Encoder(tcfg)
    assert all(isinstance(b.mlp, tt.MoEBlock) for b in enc.layers)
    dense = tt.Encoder(dataclasses.replace(tcfg, moe_experts=0))
    assert all(isinstance(b.mlp, tt.MlpBlock) for b in dense.layers)
    with torch.no_grad():  # an inference forward keeps no aux term
        enc(torch.zeros(1, 4, 16))
    assert all(b.mlp.aux_loss is None for b in enc.layers)


# ------------------------------------------------------------ the trainer

VOCAB, T, B = 128, 12, 8


def _bert_cfgs(**moe):
    kw = dict(vocab_size=VOCAB, max_len=32, **moe)
    return (jbert.bert_tiny(dtype=jnp.float32, **kw), tbert.bert_tiny(dtype=torch.float32, **kw))


def _batches(n=4, seed=0):
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((B, T), np.int32)
        for r in range(B):
            mask[r, rs.integers(3, T + 1):] = 0
        valid = np.ones(B, np.float32)
        valid[B - 1 - i % 3:] = 0.0
        out.append({"input_ids": (rs.integers(1, VOCAB, (B, T)) * mask).astype(np.int32),
                    "attention_mask": mask, "labels": rs.integers(0, 2, B).astype(np.int32),
                    "_valid": valid})
    return out


@functools.lru_cache(maxsize=None)
def _flax_bert(jcfg):
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)
    return jax.tree.map(np.asarray, nn.unbox(init(jax.random.PRNGKey(0),
                                                  np.ones((1, T), np.int32))["params"]))


def _trainers(moe, weight=0.01, steps=4, jax_side=True):
    """(JAX trainer, its state, the port's trainer, its state, the init)
    from one Flax init; the JAX pair is None without ``jax_side``."""
    jcfg, tcfg = _bert_cfgs(**moe)
    flax_init = _flax_bert(jcfg)
    common = dict(learning_rate=2e-3, total_steps=steps, grad_clip=1.0, moe_aux_weight=weight)
    jtrainer = jstate = None
    if jax_side:
        jtrainer = jtr.Trainer(jbert.BertClassifier(jcfg, 2),
                               create_mesh(MeshConfig(), devices=jax.devices()[:1]),
                               jtr.TrainerConfig(**common))
        jstate = jtrainer.resume_state(flax_init)
    ttrainer = ttr.Trainer(tbert.BertClassifier(tcfg, 2), ttr.TrainerConfig(**common),
                           device="cpu")
    init_sd = convert_jax.bert_state_dict_from_flax(flax_init)
    return jtrainer, jstate, ttrainer, ttrainer.init_state(init_params=init_sd), init_sd


_MOE_CASES = {"E=2, top-1": dict(n_layers=1, moe_experts=2, moe_top_k=1),
              "E=4, top-2": dict(n_layers=1, moe_experts=4, moe_top_k=2)}


@pytest.mark.parametrize("case", sorted(_MOE_CASES))
def test_bert_tiny_moe_steps_match_jax(case):
    """Steps of both Trainers on the same batches with the aux loss at its
    default weight: per-step loss within 1e-5, grad_norm within rtol 1e-4,
    final params as test_torch_trainer.py::test_bert_tiny_steps_match_jax
    holds them."""
    steps = 4
    jtrainer, jstate, ttrainer, tstate, init_sd = _trainers(_MOE_CASES[case], steps=steps)
    for i, batch in enumerate(_batches(steps)):
        jstate, jm = jtrainer.train_step(jstate, batch)
        tstate, tm = ttrainer.train_step(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4, err_msg=f"grad_norm at step {i}")
    want = convert_jax.bert_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    lr = 2e-3
    for name, p in tstate.params.items():
        got = p.detach().numpy()
        if name.endswith("attn.k.bias"):  # a zero exact gradient, trained on noise
            for g in (got, want[name]):
                assert np.abs(g - init_sd[name]).max() <= lr * steps, name
            continue
        off = np.abs(got - want[name]) > 2e-5
        assert off.mean() <= 1e-3, (name, int(off.sum()))
        assert np.abs(got - want[name]).max() <= lr * steps, name
        assert not np.array_equal(got, init_sd[name]), name


def test_aux_weight_changes_the_loss():
    """tests/test_moe.py::test_trainer_applies_moe_aux_loss: weight 0 against
    0.5 changes the first step's loss, by 0.5 x the layers' mean aux term
    (the weight 0.01 case is held to the JAX Trainer above)."""
    moe = dict(n_layers=2, moe_experts=2, moe_top_k=1)
    batch = _batches(1, seed=3)[0]
    losses, aux = {}, None
    for w in (0.0, 0.5):
        *_, ttrainer, tstate, _ = _trainers(moe, weight=w, jax_side=False)
        losses[w] = ttrainer.train_step(tstate, batch)[1]["loss"].item()
    _, tcfg = _bert_cfgs(**moe)
    *_, ttrainer, tstate, _ = _trainers(moe, jax_side=False)
    with torch.no_grad(), torch.enable_grad():
        ttrainer.module(**{k: torch.from_numpy(batch[k])
                           for k in ("input_ids", "attention_mask")})
        aux = [b.mlp.aux_loss.item() for b in ttrainer.module.encoder.layers]
    assert losses[0.5] > losses[0.0]
    np.testing.assert_allclose(losses[0.5] - losses[0.0], 0.5 * np.mean(aux), rtol=1e-4)


def test_moe_scan_chunk_equals_the_step_loop():
    """train_steps_scan's eager chunk (the body a captured graph runs) is
    bitwise the per-step loop, aux loss included."""
    moe = dict(moe_experts=4, moe_top_k=2, moe_dispatch="scatter")
    batches = _batches(4, seed=5)
    _, _, loop, lstate, _ = _trainers(moe, jax_side=False)
    _, _, scan, sstate, _ = _trainers(moe, jax_side=False)
    losses = [loop.train_step(lstate, b)[1]["loss"].item() for b in batches]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    sstate, m = scan.train_steps_scan(sstate, stacked)
    assert m["loss"].tolist() == losses
    for name, p in sstate.params.items():
        assert torch.equal(p, lstate.params[name]), name
