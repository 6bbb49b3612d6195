"""synapseml_torch's DeepTextClassifier against the JAX package's.

Both stages fit ``bert-tiny`` in f32 compute (the preset patched to f32 on
both sides, in the tests only) on the same small text DataFrame with the
same seed. The JAX stage initialises with ``jax.random.PRNGKey(seed)``;
the test computes that Flax init and grafts it into the port through
``text._init_params``, the port's init hook. Fitted params agree within
2e-5 on at least 99.9 % of each leaf's entries and every entry within
lr x steps (an entry whose gradient cancels to ~0 moves on rounding noise,
which Adam scales up to lr a step; the attention key bias, whose exact
gradient is 0, only moves that way); scores within 1e-4 with equal
predictions. With ``unfreeze_layers=1`` the same leaves stay bitwise at
their init on both sides. A fit with ``attn_impl='flash'`` (the flash
backward) is held the same way. The fitted model round-trips save -> load
bitwise, its init (numpy) has the Flax init's distribution, and the
unported options are refused.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synapseml_torch as pt
from synapseml_torch.models import convert_jax
from synapseml_torch.models import text as ttext
from synapseml_torch.models.nets import bert as tbert
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.models import text as jtext
from synapseml_tpu.models.flax_nets import bert as jbert

VOCAB, LR, STEPS = 512, 3e-3, 6

_WORDS = ("good great fine film plot acting score long short the a of and was is "
          "not very bad awful dull").split()


def _rows(n=40, seed=0):
    rs = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        words = list(rs.choice(_WORDS, size=int(rs.integers(2, 12))))
        rows.append({"text": " ".join(words),
                     "label": int(sum(w in ("good", "great", "fine") for w in words)
                                  > sum(w in ("bad", "awful", "dull") for w in words))})
    return rows


def _stage_kw(**kw):
    return dict(checkpoint="bert-tiny", num_classes=2, batch_size=8, max_token_len=16,
                max_steps=STEPS, learning_rate=LR, seed=0,
                tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(), **kw)


@functools.lru_cache(maxsize=1)
def _flax_init(seed=0):
    """The JAX stage's init: ``module.init(PRNGKey(seed))``, eager as its
    trainer calls it (a jitted init differs in the last bit of the normal
    draws)."""
    cfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32)
    params = jbert.BertClassifier(cfg, 2).init(jax.random.PRNGKey(seed), np.ones((1, 16), np.int32))
    return jax.tree.map(np.asarray, nn.unbox(params["params"]))


def _patched(mp):
    mp.setitem(jtext._ARCHS, "bert-tiny", functools.partial(jbert.bert_tiny, dtype=jnp.float32))
    mp.setitem(ttext._ARCHS, "bert-tiny", functools.partial(tbert.bert_tiny, dtype=torch.float32))
    init = convert_jax.bert_state_dict_from_flax(_flax_init())
    mp.setattr(ttext, "_init_params", lambda cfg, num_classes, seed: init)
    return init


@pytest.fixture(scope="module")
def fits():
    """(init, {unfreeze_layers: (JAX model, port model)}) on the same rows."""
    rows = _rows()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        init = _patched(mp)
        for unfreeze in (-1, 1):
            jmodel = jtext.DeepTextClassifier(**_stage_kw(unfreeze_layers=unfreeze)).fit(
                JDataFrame.from_rows(rows, num_partitions=2))
            tmodel = ttext.DeepTextClassifier(device="cpu", **_stage_kw(
                unfreeze_layers=unfreeze)).fit(pt.DataFrame.from_rows(rows, num_partitions=2))
            out[unfreeze] = (jmodel, tmodel)
    return init, out


def _scores(model, df):
    out = model.transform(df)
    return (np.stack(list(out.collect_column("scores"))),
            np.asarray(out.collect_column("prediction")))


def _frozen_port(name):
    return not (name.startswith(("classifier.", "pooler.", "encoder.layers.1.")))


@pytest.mark.parametrize("unfreeze", [-1, 1])
def test_fit_matches_jax(fits, unfreeze):
    init, models = fits
    _assert_fit_matches(*models[unfreeze], init, unfreeze)


def test_flash_fit_matches_jax():
    """Both stages fit with attn_impl='flash': the JAX flash_attention
    (Pallas in interpret mode) and its custom_vjp backward against the port's
    flash forward and backward (their plain versions on the CPU), held as the
    einsum fit is."""
    rows = _rows()
    with pytest.MonkeyPatch.context() as mp:
        init = _patched(mp)
        jmodel = jtext.DeepTextClassifier(**_stage_kw(attn_impl="flash")).fit(
            JDataFrame.from_rows(rows, num_partitions=2))
        tmodel = ttext.DeepTextClassifier(device="cpu", **_stage_kw(attn_impl="flash")).fit(
            pt.DataFrame.from_rows(rows, num_partitions=2))
    assert tmodel.get("arch_config").attn_impl == "flash"
    _assert_fit_matches(jmodel, tmodel, init, -1)


def _assert_fit_matches(jmodel, tmodel, init, unfreeze):
    want = convert_jax.bert_state_dict_from_flax(
        jax.tree.map(np.asarray, jmodel.get("model_params")))
    got = tmodel.get("model_params")
    assert sorted(got) == sorted(want)
    for name in got:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= LR * STEPS, name
        if not name.endswith("attn.k.bias"):
            assert (diff > 2e-5).mean() <= 1e-3, (name, int((diff > 2e-5).sum()))
        frozen = unfreeze >= 0 and _frozen_port(name)
        assert np.array_equal(got[name], init[name]) == frozen, name
        assert np.array_equal(want[name], init[name]) == frozen, name

    rows = _rows(30, seed=5)
    jscores, jpred = _scores(jmodel, JDataFrame.from_rows(rows, num_partitions=2))
    tscores, tpred = _scores(tmodel, pt.DataFrame.from_rows(rows, num_partitions=2))
    np.testing.assert_allclose(tscores, jscores, atol=1e-4)
    np.testing.assert_array_equal(tpred, jpred)
    (metrics,) = tmodel.get("train_metrics")  # one window: the last step
    assert metrics["step"] == STEPS and np.isfinite(metrics["loss"])
    assert jmodel.get("train_metrics")[-1]["step"] == STEPS


def test_fitted_model_round_trips_save_load(fits, tmp_path):
    _, models = fits
    tmodel = models[-1][1]
    df = pt.DataFrame.from_rows(_rows(20, seed=6), num_partitions=2)
    before, _ = _scores(tmodel, df)
    tmodel.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    after, _ = _scores(loaded, df)
    assert np.array_equal(before, after)
    assert loaded.get("device") == "cpu" and loaded.get("arch_config").dtype == torch.float32
    assert loaded.get("train_metrics")[0]["step"] == STEPS


def test_freeze_predicate_names_the_flax_layers():
    stage = ttext.DeepTextClassifier(unfreeze_layers=2)
    frozen = stage._freeze_predicate(12)
    jfrozen = jtext.DeepTextClassifier(unfreeze_layers=2)._freeze_predicate(12)
    names = convert_jax.bert_state_dict_from_flax(
        convert_jax.init_flax_bert_params(tbert.bert_tiny(n_layers=12, hidden=8, n_heads=2,
                                                          mlp_dim=8, vocab_size=16)))
    flax_path = {"embeddings": ("embeddings",), "pooler": ("pooler",),
                 "classifier": ("classifier",)}
    for name in names:
        parts = tuple(name.split("."))
        jpath = (("encoder", f"layer_{parts[2]}") + parts[3:] if parts[:2] == ("encoder", "layers")
                 else flax_path[parts[0]] + parts[1:])
        assert frozen(parts) == jfrozen(jpath), name
    assert not frozen(("encoder", "layers", "11", "attn", "q", "weight"))
    assert frozen(("encoder", "layers", "9", "attn", "q", "weight"))
    assert frozen(("embeddings", "word", "weight")) and not frozen(("pooler", "weight"))
    assert ttext.DeepTextClassifier()._freeze_predicate(12) is None


def test_init_has_the_flax_distribution():
    """The port's init is numpy-drawn (torch cannot reproduce jax.random
    bits): the same leaves, shapes and per-leaf distribution as the Flax
    init of the JAX stage."""
    cfg = tbert.bert_tiny(vocab_size=VOCAB, hidden=64)
    got = ttext._init_params(cfg, 2, seed=0)
    want = convert_jax.bert_state_dict_from_flax(_flax_init())
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for name in got:
        g, w = got[name], want[name]
        assert g.dtype == np.float32, name
        if np.all(w == w.flat[0]):  # biases 0, norm scales 1
            assert np.array_equal(g, w), name
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, name
            assert abs(g.mean()) < 3 * w.std() / np.sqrt(g.size), name
            assert np.abs(g).max() <= 1.5 * np.abs(w).max(), name
    again = ttext._init_params(cfg, 2, seed=0)
    assert all(np.array_equal(got[k], again[k]) for k in got)


_REFUSED = {
    "checkpoint_dir": (dict(checkpoint_dir="/tmp/ck"), "item 9"),
    "mesh_config": (dict(mesh_config=object()), "item 9"),
    "ring": (dict(attn_impl="ring"), "item 9"),
    "ulysses": (dict(attn_impl="ulysses"), "item 9"),
}


@pytest.mark.parametrize("param", sorted(_REFUSED))
def test_unported_params_are_refused(param):
    kw, item = _REFUSED[param]
    df = pt.DataFrame.from_rows(_rows(8))
    with pytest.raises(NotImplementedError, match=item):
        ttext.DeepTextClassifier(device="cpu", max_steps=1, **kw).fit(df)


def test_local_checkpoint_directory_is_refused(tmp_path):
    df = pt.DataFrame.from_rows(_rows(8))
    with pytest.raises(NotImplementedError, match="item 4"):
        ttext.DeepTextClassifier(device="cpu", checkpoint=str(tmp_path)).fit(df)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ttext.DeepTextClassifier().get("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttext.DeepTextClassifier(max_steps=1).fit(pt.DataFrame.from_rows(_rows(8)))


def test_params_match_the_jax_stage():
    jparams = {n: p.default for n, p in jtext.DeepTextClassifier.params().items()}
    tparams = {n: p.default for n, p in ttext.DeepTextClassifier.params().items()}
    assert set(tparams) - set(jparams) == {"device"}
    assert set(jparams) == set(tparams) - {"device"}
    for name, default in jparams.items():
        if name not in ("tokenizer", "mesh_config"):
            assert tparams[name] == default, name
