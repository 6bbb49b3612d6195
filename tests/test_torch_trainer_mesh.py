"""The port's Trainer on gloo meshes against the JAX Trainer on the same mesh shapes.

``bert_tiny`` in f32 with the Flax init bridged, 4 steps on the same
batches (padded rows with ``_valid = 0``), ``grad_clip=0.5`` (it bites:
the raw norms are above it) on each mesh shape:

* ``data=4`` (world 4): rows split four ways, gradients summed;
* ``data=2 x fsdp=2`` with ``zero_shard`` (world 4): each process updates
  its span of the moments and parameters;
* ``tensor=2`` (world 2): refused, naming ROADMAP.md queue A item 9 (the
  port keeps every parameter whole, so it places none);
* ``seq=2`` with ``attn_impl='ring'`` and with ``'ulysses'`` (world 2).

The JAX side is ``synapseml_tpu``'s ``Trainer`` on a mesh of the same
shape over as many of its CPU devices, with its rule table (which places
the parameters over fsdp) and ZeRO where the port has ZeRO: the port's
table places no parameter. Held, as ``test_torch_trainer.py`` holds one device: the
per-step loss within 1e-5, the grad norm (the global one) within rtol
1e-4, the final params within 2e-5 on at least 99.9 % of each leaf's
entries and every entry within lr x steps (the attention key bias, whose
exact gradient is 0, within lr x steps of its init on both sides); every
rank's params equal rank 0's bitwise.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_rank_cases import TRAINER_COMMON, VOCAB, T, trainer_batches
from _torch_ranks import spawn
from synapseml_torch.models import convert_jax
from synapseml_tpu.models import trainer as jt
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.parallel import partition as jpart
from synapseml_tpu.parallel.mesh import MeshConfig, create_mesh

CASES = {
    4: [dict(name="data4", mesh=dict(data=4)),
        dict(name="data2_fsdp2_zero", mesh=dict(data=2, fsdp=2),
             extra=dict(rules=True, zero=True))],
    2: [dict(name="tensor2", mesh=dict(data=1, tensor=2), refused=True),
        dict(name="seq2_ring", mesh=dict(data=1, seq=2), extra=dict(attn_impl="ring")),
        dict(name="seq2_ulysses", mesh=dict(data=1, seq=2), extra=dict(attn_impl="ulysses"))],
}


@pytest.fixture(scope="module")
def flax_init():
    cfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32, max_len=32)
    init = jax.jit(jbert.BertClassifier(cfg, 2).init)
    tree = nn.unbox(init(jax.random.PRNGKey(0), np.ones((1, T), np.int32))["params"])
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def worlds(flax_init, tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer_init")
    np.savez(d / "init.npz", **convert_jax.bert_state_dict_from_flax(flax_init))
    return {w: spawn("_torch_rank_cases:trainer_suite", w, tmp_path_factory.mktemp(f"tr{w}"),
                     init=str(d / "init.npz"), cases=cases)
            for w, cases in CASES.items()}


def _jax_run(flax_init, case, n):
    extra = case.get("extra", {})
    shape = MeshConfig(**case["mesh"])
    mesh = create_mesh(shape, devices=jax.devices()[:n], allow_fewer=False)
    cfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32, max_len=32,
                          attn_impl=extra.get("attn_impl", "einsum"))
    rules = jpart.default_transformer_rules(shape) if extra.get("rules") else None
    trainer = jt.Trainer(jbert.BertClassifier(cfg, 2), mesh,
                         jt.TrainerConfig(partition_rules=rules,
                                          zero_shard=bool(extra.get("zero")),
                                          **TRAINER_COMMON))
    state = trainer.resume_state(flax_init)
    losses, norms = [], []
    for batch in trainer_batches():
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = convert_jax.bert_state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    return np.array(losses), np.array(norms), params


@pytest.mark.parametrize("world,case", [(w, c["name"]) for w, cs in CASES.items() for c in cs])
def test_mesh_steps_match_jax(worlds, flax_init, world, case):
    spec = next(c for c in CASES[world] if c["name"] == case)
    ranks = worlds[world]
    if spec.get("refused"):
        for got in ranks:
            msg = str(got[f"{case}/refused"][0])
            assert "queue A item 9" in msg and "ensor parallelism" in msg, msg
        return
    losses, norms, want = _jax_run(flax_init, spec, world)
    got = ranks[0]
    assert (norms > TRAINER_COMMON["grad_clip"]).all()  # the clip bites
    np.testing.assert_allclose(got[f"{case}/loss"], losses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[f"{case}/grad_norm"], norms, rtol=1e-4)
    lr, steps = TRAINER_COMMON["learning_rate"], len(losses)
    init = convert_jax.bert_state_dict_from_flax(flax_init)
    for name, w in want.items():
        g = got[f"{case}/p/{name}"]
        for r, other in enumerate(ranks[1:], start=1):
            assert np.array_equal(other[f"{case}/p/{name}"], g), (r, name)
        if name.endswith("attn.k.bias"):
            # its gradient is 0 in exact arithmetic: both sides train it on
            # rounding noise, which Adam scales up to at most lr a step
            for x in (g, w):
                assert np.abs(x - init[name]).max() <= lr * steps, name
            continue
        off = np.abs(g - w) > 2e-5
        assert off.mean() <= 1e-3, (name, int(off.sum()))
        assert np.abs(g - w).max() <= lr * steps, name


def test_zero_steps_equal_the_whole_moment_steps_bitwise(worlds):
    # ZeRO's update is elementwise on each process's span, so the data=2 x
    # fsdp=2 steps with zero_shard equal the data=4 steps without it, bit
    # for bit, on every rank (the same 4-way split, the same gradient sum)
    for r, got in enumerate(worlds[4]):
        for key in got:
            if key.startswith("data4/"):
                other = "data2_fsdp2_zero/" + key[len("data4/"):]
                assert np.array_equal(got[key], got[other]), (r, key)
