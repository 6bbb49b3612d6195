"""synapseml_torch BERT nets against the Flax BertClassifier.

The Flax model's params (perturbed with seeded numpy noise so that biases
and norm scales are not their trivial initial values) cross over through
``convert_jax.bert_state_dict_from_flax``; both models score the same
numpy ids. f32 logits agree within 1e-4 (sums in different orders); the
bf16 default within 3e-2 on softmax scores (bf16 rounds at other places in
the two frameworks).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import bert as tbert
from synapseml_tpu.models.flax_nets import bert as jbert


def _inputs(seed=0, B=3, T=16, vocab=1024):
    rs = np.random.default_rng(seed)
    ids = rs.integers(2, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 10:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _flax_params(jcfg, ids, seed=0):
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)  # eager init costs seconds
    params = nn.unbox(init(jax.random.PRNGKey(seed), ids)["params"])
    rs = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (np.asarray(a) + rs.normal(scale=0.05, size=a.shape)
                                   ).astype(np.float32), params)


def _flax_logits(jcfg, params, ids, mask):
    apply = jax.jit(jbert.BertClassifier(jcfg, 2).apply)  # eager apply costs seconds
    return np.asarray(apply({"params": params}, ids, mask))


def _torch_model(tcfg, params):
    model = tbert.BertClassifier(tcfg, 2)
    state = {k: torch.from_numpy(v) for k, v in
             convert_jax.bert_state_dict_from_flax(params).items()}
    model.load_state_dict(state)  # strict: every key mapped, none left over
    return model.eval()


def _logits(model, ids, mask):
    with torch.inference_mode():
        m = None if mask is None else torch.from_numpy(mask)
        return model(torch.from_numpy(ids), m).float().numpy()


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_f32_logits_match_flax(impl, with_mask):
    ids, mask = _inputs()
    mask = mask if with_mask else None
    jcfg = jbert.bert_tiny(dtype=jnp.float32, attn_impl=impl)
    params = _flax_params(jcfg, ids)
    want = _flax_logits(jcfg, params, ids, mask)
    model = _torch_model(tbert.bert_tiny(dtype=torch.float32, attn_impl=impl), params)
    np.testing.assert_allclose(_logits(model, ids, mask), want, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_bf16_default_scores_match_flax(impl):
    ids, mask = _inputs(seed=1)
    jcfg = jbert.bert_tiny(attn_impl=impl)
    params = _flax_params(jcfg, ids, seed=1)
    want = np.asarray(jax.nn.softmax(_flax_logits(jcfg, params, ids, mask), axis=-1))
    model = _torch_model(tbert.bert_tiny(attn_impl=impl), params)
    got = torch.softmax(torch.from_numpy(_logits(model, ids, mask)), -1).numpy()
    np.testing.assert_allclose(got, want, atol=3e-2)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_prenorm_stack_matches_flax(norm):
    """Pre-norm blocks with the encoder-level final norm (the legacy BERT
    layout and the ViT/Llama structure), tanh GELU, both norm kinds."""
    ids, mask = _inputs(seed=2)
    over = dict(norm_position="pre", norm_eps=1e-6, act="gelu_tanh", norm=norm)
    jcfg = dataclasses.replace(jbert.bert_tiny(dtype=jnp.float32), **over)
    params = _flax_params(jcfg, ids, seed=2)
    assert "LayerNorm_0" in params["encoder"] or "RMSNorm_0" in params["encoder"]
    want = _flax_logits(jcfg, params, ids, mask)
    model = _torch_model(dataclasses.replace(tbert.bert_tiny(dtype=torch.float32), **over),
                         params)
    np.testing.assert_allclose(_logits(model, ids, mask), want, atol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_causal_gqa_gated_stack_matches_flax(impl):
    """The rest of the ported block: causal masks on both attention paths,
    grouped-query heads and a gated (SwiGLU) MLP."""
    ids, mask = _inputs(seed=3)
    over = dict(causal=True, n_heads=4, n_kv_heads=2, gated_mlp=True, act="silu",
                norm="rmsnorm", norm_position="pre", attn_impl=impl)
    jcfg = dataclasses.replace(jbert.bert_tiny(dtype=jnp.float32), **over)
    params = _flax_params(jcfg, ids, seed=3)
    want = _flax_logits(jcfg, params, ids, mask)
    model = _torch_model(dataclasses.replace(tbert.bert_tiny(dtype=torch.float32), **over),
                         params)
    np.testing.assert_allclose(_logits(model, ids, mask), want, atol=1e-4)


def test_numpy_initialiser_has_the_flax_layout():
    """init_flax_bert_params makes the tree Flax's init makes: same paths,
    shapes and dtypes, so the bridge serves both."""
    ids, _ = _inputs()
    cfg_kw = dict(vocab_size=512, n_layers=3)
    init = jax.jit(jbert.BertClassifier(jbert.bert_tiny(**cfg_kw), 3).init)
    flax_tree = nn.unbox(init(jax.random.PRNGKey(0), ids % 512)["params"])
    ours = convert_jax.init_flax_bert_params(tbert.bert_tiny(**cfg_kw), num_classes=3, seed=7)

    def shapes(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), str(np.asarray(a).dtype)), tree)

    assert shapes(ours) == shapes(jax.tree.map(np.asarray, flax_tree))
    again = convert_jax.init_flax_bert_params(tbert.bert_tiny(**cfg_kw), num_classes=3, seed=7)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(again)))


def test_bridge_rejects_a_foreign_tree():
    with pytest.raises(KeyError, match="unexpected"):
        convert_jax.bert_state_dict_from_flax({"embeddings": {}, "decoder": {}})
