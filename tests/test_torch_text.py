"""synapseml_torch DeepTextModel against the JAX package's DeepTextModel.

Both stages score the same multi-partition DataFrame, whose partitions
tokenize to different lengths and end in partial buckets, with the same
weights: the JAX model holds the Flax tree, the port its bridged
state_dict. f32 scores agree within 1e-4 with equal predictions; the bf16
default within 3e-2.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# torch._dynamo is imported here, at collection, on purpose: the ONNX export
# tests install a spec-less ``onnx`` stand-in in sys.modules, and a later first
# import of torch._dynamo (which calls find_spec("onnx")) then raises. Every
# xdist worker collects every test file before it runs any test, so with this
# import dynamo is in place in each worker before any stand-in is.
import torch._dynamo  # noqa: F401

import synapseml_torch as pt
from synapseml_torch.core import get_tracer
from synapseml_torch.models import convert_jax
from synapseml_torch.models import text as ttext
from synapseml_torch.models.nets import bert as tbert
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.models.flax_nets import bert as jbert
from synapseml_tpu.models.text import DeepTextModel as JDeepTextModel

VOCAB = 256

_WORDS = ("good great bad awful film plot acting score long short the a of "
          "and was is not very really quite").split()


def _texts(n=23, seed=0):
    rs = np.random.default_rng(seed)
    return [" ".join(rs.choice(_WORDS, size=int(rs.integers(1, 14))))
            for _ in range(n)]


def _rows(n=23, seed=0):
    return [{"text": t} for t in _texts(n, seed)]


def _flax_params(jcfg, seed=0):
    ids = np.ones((1, 8), np.int32)
    init = jax.jit(jbert.BertClassifier(jcfg, 2).init)
    params = nn.unbox(init(jax.random.PRNGKey(seed), ids)["params"])
    rs = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (np.asarray(a) + rs.normal(scale=0.05, size=a.shape)
                                   ).astype(np.float32), params)


def _models(dtype_name, **port_kw):
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    jcfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jdtype)
    params = _flax_params(jcfg)
    tok = HashingTokenizer(vocab_size=VOCAB).to_config()
    common = dict(tokenizer_config=tok, checkpoint="bert-tiny", num_classes=2,
                  max_token_len=16, batch_size=4)
    jmodel = JDeepTextModel(model_params=params, arch_config=jcfg, **common)
    tmodel = ttext.DeepTextModel(
        model_params=convert_jax.bert_state_dict_from_flax(params),
        arch_config=tbert.bert_tiny(vocab_size=VOCAB, dtype=tdtype),
        device="cpu", **common, **port_kw)
    return jmodel, tmodel


def _scores(model, df):
    out = model.transform(df)
    return (np.stack(list(out.collect_column("scores"))),
            np.asarray(out.collect_column("prediction")))


@pytest.mark.parametrize("dtype_name,atol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_transform_matches_jax(dtype_name, atol):
    rows = _rows()
    jmodel, tmodel = _models(dtype_name)
    # 23 rows in 3 partitions of 8/7/8 with batch_size 4: the middle one
    # ends in a partial bucket, and each tokenizes to its own padded length
    want, want_pred = _scores(jmodel, JDataFrame.from_rows(rows, num_partitions=3))
    got, got_pred = _scores(tmodel, pt.DataFrame.from_rows(rows, num_partitions=3))
    assert got.shape == (23, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    if dtype_name == "f32":
        np.testing.assert_array_equal(got_pred, want_pred)


def test_flash_and_einsum_agree_and_set_rebuilds_the_module():
    df = pt.DataFrame.from_rows(_rows(seed=1), num_partitions=2)
    _, tmodel = _models("f32")
    einsum, _ = _scores(tmodel, df)
    built = tmodel._module
    tmodel.set(attn_impl="flash")
    assert tmodel._module is None  # a param the module captured changed
    flash, _ = _scores(tmodel, df)
    assert tmodel._module is not built and tmodel._module.cfg.attn_impl == "flash"
    np.testing.assert_allclose(flash, einsum, atol=1e-5)
    tmodel.set(scores_col="probs")  # not a module input: the module stays
    assert tmodel._module is not None


def test_save_load_round_trip(tmp_path):
    df = pt.DataFrame.from_rows(_rows(seed=2), num_partitions=2)
    _, tmodel = _models("bf16", attn_impl="flash")
    before, _ = _scores(tmodel, df)
    tmodel.save(str(tmp_path / "m"))
    loaded = pt.load_stage(str(tmp_path / "m"))
    assert isinstance(loaded, ttext.DeepTextModel)
    assert loaded.get("arch_config").dtype == torch.bfloat16
    assert loaded.get("attn_impl") == "flash" and loaded.get("device") == "cpu"
    after, _ = _scores(loaded, df)
    np.testing.assert_array_equal(after, before)


def test_legacy_prenorm_artifact_scores_as_trained():
    """A state_dict with an encoder-level final norm and no arch_config is
    rebuilt as the pre-norm architecture it was trained as."""
    old = dataclasses.replace(jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32),
                              norm_position="pre", norm_eps=1e-6, act="gelu_tanh")
    params = _flax_params(old, seed=3)
    tok = HashingTokenizer(vocab_size=VOCAB)
    model = ttext.DeepTextModel(model_params=convert_jax.bert_state_dict_from_flax(params),
                                tokenizer_config=tok.to_config(), checkpoint="bert-tiny",
                                max_token_len=8, batch_size=4, device="cpu")
    got, _ = _scores(model, pt.DataFrame.from_rows([{"text": "hello world"}]))
    enc = tok(["hello world"], max_len=8)
    want = jax.nn.softmax(jax.jit(jbert.BertClassifier(old, 2).apply)(
        {"params": params}, enc["input_ids"], enc["attention_mask"]), axis=-1)
    # the served model computes in bf16 (the preset's default), the reference in f32
    np.testing.assert_allclose(got[0], np.asarray(want)[0], atol=5e-3)


def test_default_device_is_the_card():
    """The no-device default is 'cuda'; on a host without a CUDA device it
    raises instead of scoring on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, tmodel = _models("f32")
    tmodel.clear("device")
    assert tmodel.get("device") == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.transform(pt.DataFrame.from_rows(_rows(n=3)))


def test_param_validation_and_missing_column():
    with pytest.raises(ValueError, match="attn_impl"):
        ttext.DeepTextModel(attn_impl="ring")
    with pytest.raises(ValueError, match="device"):
        ttext.DeepTextModel(device="tpu:0")
    _, tmodel = _models("f32")
    with pytest.raises(ValueError, match="not found"):
        tmodel.transform(pt.DataFrame.from_rows([{"body": "x"}]))
    tmodel.set(tokenizer_config=HashingTokenizer(vocab_size=4 * VOCAB).to_config())
    with pytest.raises(ValueError, match="exceeds the model's embedding table"):
        tmodel.transform(pt.DataFrame.from_rows(_rows(n=3)))


def test_transform_is_traced():
    get_tracer().clear()
    _, tmodel = _models("f32")
    pt.PipelineModel(stages=[tmodel]).transform(pt.DataFrame.from_rows(_rows(n=5)))
    spans = {s["name"]: s for s in get_tracer().spans_as_dicts()}
    assert spans["DeepTextModel.transform"]["parent"] == "pipeline.stage[0]"
    assert spans["pipeline.stage[0]"]["parent"] == "PipelineModel.transform"


def test_module_build_imports_no_dynamo():
    """Building and scoring a DeepTextModel imports no torch._dynamo, so it
    works with a spec-less ``onnx`` stand-in in sys.modules (a fresh
    interpreter: this process has dynamo already)."""
    script = textwrap.dedent("""
        import sys, types
        sys.modules["onnx"] = types.ModuleType("onnx")
        import torch
        import synapseml_torch as pt
        from synapseml_torch.models import text
        from synapseml_torch.models.nets import bert
        from synapseml_torch.models.tokenizer import HashingTokenizer
        cfg = bert.bert_tiny(vocab_size=256, dtype=torch.float32)
        params = {k: v.numpy() for k, v in bert.BertClassifier(cfg).state_dict().items()}
        model = text.DeepTextModel(model_params=params, arch_config=cfg,
                                   tokenizer_config=HashingTokenizer(vocab_size=256).to_config(),
                                   max_token_len=16, batch_size=4, device="cpu",
                                   attn_impl="flash")
        out = model.transform(pt.DataFrame.from_rows([{"text": "good film"}, {"text": "bad"}]))
        assert len(out.collect_column("scores")) == 2
        assert "torch._dynamo" not in sys.modules, "scoring imported torch._dynamo"
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]
