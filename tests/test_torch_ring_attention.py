"""Ring and Ulysses attention of the port over gloo worlds of 2 and 4.

Every process passes the same global ``[B, T, H, D]`` f32 q, k, v (B 2, T
32, H 4, D 16, a padding mask on the tail of one row and the middle of
the other) to ``ring_attention_sharded`` / ``ulysses_attention_sharded``
on a mesh whose ``seq`` axis spans the world, and differentiates
``sum(out * g)``. Held to the JAX package's functions of the same names on
a ``seq`` mesh of as many CPU devices (JAX's flash, Ulysses's local step,
as its own tests run it on the CPU), non-causal and causal: forward within
1e-5, dq/dk/dv within 5e-5. The ring runs blocks of 4 keys (several chunks
a block). At one process the sequence-parallel functions run their ring of
one and their Ulysses step without an all-to-all; they are held to the
port's flash attention there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rank_cases import attention_inputs
from _torch_ranks import spawn
from synapseml_tpu.ops.ring_attention import ring_attention_sharded as jring
from synapseml_tpu.ops.ulysses_attention import ulysses_attention_sharded as julysses
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

SEED = 11
TOL_OUT, TOL_GRAD = 1e-5, 5e-5


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: spawn("_torch_rank_cases:ring_suite", w, tmp_path_factory.mktemp(f"ring{w}"),
                     seed=SEED) for w in (2, 4)}


def _jax_case(impl, n, causal):
    q, k, v, mask, g = attention_inputs(SEED)
    mesh = create_mesh(MeshConfig(data=1, seq=n), devices=jax.devices()[:n])
    fn = jring if impl == "ring" else julysses
    kw = dict(kv_mask=jnp.asarray(mask), causal=causal)
    if impl == "ring":
        kw["chunk"] = 4

    def loss(q_, k_, v_):
        out = fn(mesh, q_, k_, v_, **kw)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_on_a_seq_mesh(worlds, world, impl, causal):
    out, grads = _jax_case(impl, world, causal)
    tag = f"{impl}/{int(causal)}"
    for r, got in enumerate(worlds[world]):
        np.testing.assert_allclose(got[f"{tag}/out"], out, atol=TOL_OUT, rtol=0,
                                   err_msg=f"rank {r}")
        for name, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[f"{tag}/{name}"], want, atol=TOL_GRAD, rtol=0,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_one_process_runs_the_algorithm(impl, causal):
    from synapseml_torch import parallel as pp
    from synapseml_torch.ops import attention, ring_attention_sharded, ulysses_attention_sharded

    q, k, v, mask, g = attention_inputs(SEED)
    mesh = pp.create_mesh(pp.MeshConfig())
    fn = ring_attention_sharded if impl == "ring" else ulysses_attention_sharded
    grads = []
    outs = []
    for f in (lambda *a: fn(mesh, *a, kv_mask=torch.from_numpy(mask), causal=causal),
              lambda *a: attention.flash_attention(*a, kv_mask=torch.from_numpy(mask),
                                                   causal=causal)):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = f(qt, kt, vt)
        (o * torch.from_numpy(g)).sum().backward()
        outs.append(o.detach().numpy())
        grads.append([t.grad.numpy() for t in (qt, kt, vt)])
    np.testing.assert_allclose(outs[0], outs[1], atol=TOL_OUT, rtol=0)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=TOL_GRAD, rtol=0)


def test_module_dispatch_falls_back_to_flash_without_a_seq_mesh():
    """attn_impl='ring' with no mesh in scope: a warning and the flash
    path, as the JAX module dispatches."""
    import dataclasses

    from synapseml_torch.models.nets import bert

    cfg = bert.bert_tiny(vocab_size=64, dtype=torch.float32, max_len=16)
    torch.manual_seed(0)
    flash = bert.BertClassifier(dataclasses.replace(cfg, attn_impl="flash"), 2)
    ring = bert.BertClassifier(dataclasses.replace(cfg, attn_impl="ring"), 2)
    ring.load_state_dict(flash.state_dict())
    ids = torch.randint(1, 64, (2, 8))
    mask = torch.ones(2, 8, dtype=torch.int32)
    with pytest.warns(UserWarning, match="no mesh"):
        got = ring(ids, mask)
    assert torch.equal(got, flash(ids, mask))
