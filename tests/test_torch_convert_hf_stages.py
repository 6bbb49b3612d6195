"""synapseml_torch's pretrained stages from a checkpoint directory, against
the JAX package's stages on the same directory (``tests/_hf_checkpoints.py``
writes each with ``transformers``, no download):

* ``DeepTextClassifier`` (through the flash kernels' plain versions) and
  ``DeepVisionClassifier`` (ViT and ResNet, BatchNorm statistics as the
  initial state) fit as the JAX stages fit, configs patched to f32 on both
  sides: the initial state bitwise the mapping, fitted parameters within
  the rule of test_torch_text_classifier.py, scores within 1e-4;
* ``HuggingFaceCausalLM(model_name=<dir>)`` (Llama; GPT-2 dense, the paged
  engine refusing it in both packages) with completions equal to the JAX
  stage's, and ``drafter_ref=<dir>``;
* the vocab guard and the "pass tokenizer=" error.
"""

import functools

import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C)
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
from _hf_checkpoints import (bert_dir, flax_np, gpt2_dir, llama_dir, resnet_dir,  # noqa: E402
                             same_state, save_ckpt, vit_dir)

import synapseml_torch as pt  # noqa: E402
from synapseml_torch.hf import causal_lm as tcl  # noqa: E402
from synapseml_torch.models import convert_hf as T  # noqa: E402
from synapseml_torch.models import convert_jax  # noqa: E402
from synapseml_torch.models import text as ttext  # noqa: E402
from synapseml_torch.models import vision as tvision  # noqa: E402
from synapseml_torch.models.nets import resnet as tresnet  # noqa: E402
from synapseml_torch.models.tokenizer import HashingTokenizer  # noqa: E402
from synapseml_tpu.core import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.hf import causal_lm as jcl  # noqa: E402
from synapseml_tpu.models import convert_hf as J  # noqa: E402
from synapseml_tpu.models import text as jtext  # noqa: E402
from synapseml_tpu.models import vision as jvision  # noqa: E402
from synapseml_tpu.models.flax_nets import resnet as jresnet  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory):
    return bert_dir(tmp_path_factory.mktemp("bert"))


_WORDS = "good great fine bad awful poor film plot the a".split()


def _text_rows(n=24, seed=0):
    rs = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        words = list(rs.choice(_WORDS, size=int(rs.integers(2, 8))))
        rows.append({"text": " ".join(words),
                     "label": int(sum(w in ("good", "great", "fine") for w in words)
                                  >= sum(w in ("bad", "awful", "poor") for w in words))})
    return rows


def _assert_fitted_alike(got: dict, want: dict, lr: float, steps: int) -> None:
    """As test_torch_text_classifier's rule: every entry within lr x steps,
    at most 0.1 % of a leaf's entries past 2e-5 (Adam scales rounding noise
    on cancelling gradients up to lr a step)."""
    assert sorted(got) == sorted(want)
    for name in got:
        diff = np.abs(got[name] - want[name])
        assert diff.max() <= lr * steps, name
        if not name.endswith("attn.k.bias"):
            assert (diff > 2e-5).mean() <= 1e-3, (name, int((diff > 2e-5).sum()))


@pytest.mark.parametrize("attn_impl", ["flash"])
def test_deep_text_classifier_from_checkpoint_dir(bert_ckpt, attn_impl, tmp_path):
    """The fit of a checkpoint directory: the mapped weights (the head kept,
    3 classes) as the initial state on both sides, f32 on both, the fitted
    parameters and scores as the JAX stage's, arch_config from config.json,
    save -> load bitwise. Through the flash kernels' plain versions (the
    einsum fit is held to the JAX stage in test_torch_text_classifier.py)."""
    d, _ = bert_ckpt
    lr, steps = 5e-3, 6
    kw = dict(checkpoint=d, num_classes=3, batch_size=8, max_token_len=16, max_steps=steps,
              learning_rate=lr, attn_impl=attn_impl,
              tokenizer=HashingTokenizer(vocab_size=97).to_config())
    rows = _text_rows()
    for r in rows:
        r["label"] = r["label"] + (len(r["text"]) % 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "pretrained_text_classifier",
                   functools.partial(J.pretrained_text_classifier, dtype=jnp.float32))
        mp.setattr(ttext, "pretrained_text_classifier",
                   functools.partial(T.pretrained_text_classifier, dtype=torch.float32))
        jmodel = jtext.DeepTextClassifier(**kw).fit(JDataFrame.from_rows(rows, num_partitions=2))
        stage = ttext.DeepTextClassifier(device="cpu", **kw)
        _, _, fit_kw, cfg, _ = stage._fit_plan(pt.DataFrame.from_rows(rows))
        tmodel = stage.fit(pt.DataFrame.from_rows(rows, num_partitions=2))
    same_state(fit_kw["init_params"], T.pretrained_text_classifier(d, num_classes=3)[1])
    assert cfg.hidden == 48 and cfg.attn_impl == attn_impl
    assert tmodel.get("arch_config") == cfg and tmodel.get("checkpoint") == d
    want = convert_jax.bert_state_dict_from_flax(flax_np(jmodel.get("model_params")))
    _assert_fitted_alike(tmodel.get("model_params"), want, lr, steps)

    df_rows = _text_rows(10, seed=3)
    jout = jmodel.transform(JDataFrame.from_rows(df_rows))
    df = pt.DataFrame.from_rows(df_rows, num_partitions=2)
    tout = tmodel.transform(df)
    tscores = np.stack(list(tout.collect_column("scores")))
    np.testing.assert_allclose(tscores, np.stack(list(jout.collect_column("scores"))), atol=1e-4)
    tmodel.save(str(tmp_path / "m"))
    again = pt.load_stage(str(tmp_path / "m")).transform(df)
    assert np.array_equal(np.stack(list(again.collect_column("scores"))), tscores)


def _vision_rows(hw=32, n=16):
    rs = np.random.default_rng(0)
    labels = (np.arange(n) % 2).astype(np.int32)
    imgs = (np.full((n, hw, hw, 3), 0.5, np.float32) * labels[:, None, None, None]
            + rs.normal(0, 0.1, (n, hw, hw, 3)).astype(np.float32))
    return {"image": imgs, "label": labels}


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_deep_vision_classifier_from_checkpoint_dir(tmp_path, family):
    """The fit of a ViT or ResNet directory (a new 2-class head seeded as
    the JAX mapping seeds it; for the ResNet the checkpoint's BatchNorm
    statistics as the initial batch_stats), f32 on both sides: parameters,
    statistics and scores as the JAX stage's; the model rebuilds from its
    arch_spec."""
    make = vit_dir if family == "vit" else resnet_dir
    d, _ = make(tmp_path / family)
    lr, steps = 3e-3, 3
    kw = dict(backbone=d, num_classes=2, batch_size=8, max_steps=steps, learning_rate=lr,
              seed=1)
    data = _vision_rows(32 if family == "vit" else 16)  # the ViT's config: 32 x 32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "pretrained_vision", functools.partial(J.pretrained_vision,
                                                             dtype=jnp.float32))
        mp.setattr(tvision, "pretrained_vision", functools.partial(T.pretrained_vision,
                                                                   dtype=torch.float32))
        mp.setattr(jresnet, "ResNet", functools.partial(jresnet.ResNet, dtype=jnp.float32))
        mp.setattr(tvision, "ResNet", functools.partial(tresnet.ResNet, dtype=torch.float32))
        jmodel = jvision.DeepVisionClassifier(**kw).fit(JDataFrame.from_dict(data,
                                                                             num_partitions=2))
        stage = tvision.DeepVisionClassifier(device="cpu", **kw)
        _, _, fit_kw, arch_spec = stage._fit_plan(pt.DataFrame.from_dict(data))
        tmodel = stage.fit(pt.DataFrame.from_dict(data, num_partitions=2))
        x = data["image"][:5] + 0.05
        jscores = np.stack(list(jmodel.transform(JDataFrame.from_dict({"image": x}))
                                .collect_column("scores")))
        tscores = np.stack(list(tmodel.transform(pt.DataFrame.from_dict({"image": x}))
                                .collect_column("scores")))
    _, _, variables = T.pretrained_vision(d, num_classes=2, seed=1)
    same_state(fit_kw["init_params"], variables["params"])
    assert arch_spec[0] == family and tmodel.get("arch_spec")[0] == family
    if family == "vit":
        bridge = convert_jax.vit_state_dict_from_flax
        assert fit_kw["init_batch_stats"] is None and tmodel.get("batch_stats") is None
    else:
        bridge = convert_jax.resnet_state_dict_from_flax
        same_state(fit_kw["init_batch_stats"], variables["batch_stats"])
        want_stats = bridge(batch_stats=flax_np(jmodel.get("batch_stats")))
        for name, v in tmodel.get("batch_stats").items():
            np.testing.assert_allclose(v, want_stats[name], atol=2e-5, rtol=0, err_msg=name)
    _assert_fitted_alike(tmodel.get("model_params"), bridge(flax_np(jmodel.get("model_params"))),
                         lr, steps)
    np.testing.assert_allclose(tscores, jscores, atol=1e-4)


def _lm_kw(d, vocab, **over):
    kw = dict(model_name=d, tokenizer=HashingTokenizer(vocab_size=vocab).to_config(),
              max_new_tokens=6, prompt_bucket=8, batch_size=2)
    kw.update(over)
    return kw


_PROMPTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a",
            "paged engines free their pages"]


def _completions(df):
    return [np.asarray(r).tolist() for r in df.collect_column("completions")]


@pytest.fixture
def f32_causal_lm(monkeypatch):
    monkeypatch.setattr(J, "pretrained_causal_lm",
                        functools.partial(J.pretrained_causal_lm, dtype=jnp.float32))
    monkeypatch.setattr(tcl, "pretrained_causal_lm",
                        functools.partial(T.pretrained_causal_lm, dtype=torch.float32))


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_causal_lm_from_checkpoint_dir(tmp_path, f32_causal_lm, family, engine):
    """HuggingFaceCausalLM(model_name=<dir>): the directory's weights (bitwise
    the mapping), completions equal to the JAX stage's over two partitions."""
    d, _ = (llama_dir if family == "llama" else gpt2_dir)(tmp_path / family)
    vocab = 89 if family == "llama" else 93
    data = {"prompt": np.asarray(_PROMPTS, dtype=object)}
    if family == "gpt2" and engine == "paged":  # the RoPE family only, in both packages
        with pytest.raises(ValueError, match="paged engine supports"):
            jcl.HuggingFaceCausalLM(**_lm_kw(d, vocab, engine=engine)).transform(
                JDataFrame.from_dict(data))
        with pytest.raises(ValueError, match="paged engine supports"):
            tcl.HuggingFaceCausalLM(**_lm_kw(d, vocab, engine=engine), device="cpu").transform(
                pt.DataFrame.from_dict(data))
        return
    want = _completions(jcl.HuggingFaceCausalLM(**_lm_kw(d, vocab, engine=engine)).transform(
        JDataFrame.from_dict(data, num_partitions=2)))
    stage = tcl.HuggingFaceCausalLM(**_lm_kw(d, vocab, engine=engine), device="cpu")
    got = _completions(stage.transform(pt.DataFrame.from_dict(data, num_partitions=2)))
    assert got == want and all(len(r) == 6 for r in got)
    model, _ = stage._model_and_tokenizer()
    _, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    assert all(torch.equal(v, torch.from_numpy(np.array(sd[k])))
               for k, v in model.state_dict().items())


def test_drafter_ref_as_a_directory(tmp_path, f32_causal_lm):
    """drafter_ref=<dir>: a one-layer Llama drafter from its own directory
    for a two-layer target; speculative completions equal the JAX stage's
    (and plain decode's), the engine's drafter holds the directory's
    weights."""
    d, _ = llama_dir(tmp_path / "target", seed=2, layers=2)
    dd, _ = llama_dir(tmp_path / "drafter", seed=12, layers=1)
    data = {"prompt": np.asarray(_PROMPTS, dtype=object)}
    kw = _lm_kw(d, 89, engine="paged", draft_tokens=2, drafter_ref=dd)
    want = _completions(jcl.HuggingFaceCausalLM(**kw).transform(
        JDataFrame.from_dict(data, num_partitions=2)))
    stage = tcl.HuggingFaceCausalLM(**kw, device="cpu")
    got = _completions(stage.transform(pt.DataFrame.from_dict(data, num_partitions=2)))
    plain = _completions(tcl.HuggingFaceCausalLM(**_lm_kw(d, 89, engine="paged"),
                                                 device="cpu").transform(
        pt.DataFrame.from_dict(data, num_partitions=2)))
    assert got == want == plain
    drafter = stage._paged_engine(stage._effective_gen_cfg())._drafter
    _, dsd = T.pretrained_causal_lm(dd, dtype=torch.float32)
    assert drafter.cfg.n_layers == 1
    assert all(torch.equal(v.float(), torch.from_numpy(np.array(dsd[k])))
               for k, v in drafter.state_dict().items())


def test_vocab_guard_on_pretrained_paths(tmp_path):
    """An oversized tokenizer vocab fails loudly on every pretrained path,
    and tokenizer=None on a model-only directory asks for one."""
    d, _ = llama_dir(tmp_path / "llama", layers=1)
    df = pt.DataFrame.from_rows([{"prompt": "x"}])
    lm = tcl.HuggingFaceCausalLM(model_name=d, tokenizer=HashingTokenizer(), device="cpu")
    with pytest.raises(ValueError, match="exceeds the checkpoint"):
        lm.transform(df)
    with pytest.raises(ValueError, match="pass tokenizer="):
        tcl.HuggingFaceCausalLM(model_name=d, device="cpu").transform(df)
    bd = tmp_path / "bert"
    from transformers import BertConfig, BertModel

    bcfg = BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=32, max_position_embeddings=32)
    save_ckpt(BertModel(bcfg), bd, bcfg)
    rows = pt.DataFrame.from_rows([{"text": "a b", "label": 0}, {"text": "c", "label": 1}])
    with pytest.raises(ValueError, match="exceeds the checkpoint"):
        ttext.DeepTextClassifier(checkpoint=str(bd), tokenizer=HashingTokenizer(),
                                 device="cpu").fit(rows)
    with pytest.raises(ValueError, match="pass tokenizer="):
        ttext.DeepTextClassifier(checkpoint=str(bd), device="cpu").fit(rows)
