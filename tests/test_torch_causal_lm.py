"""synapseml_torch's HuggingFaceCausalLM against the JAX package's stage.

Both stages generate from the same multi-partition DataFrame with the same
weights: the JAX stage holds the Flax tree of ``llama-tiny`` in f32 (the
presets patched to f32 on both sides), the port its bridged state_dict.
Completions are token-identical, dense and paged, and paged with the prefix
cache and speculation on. The Params are the JAX
stage's plus ``device``; each unported one is refused naming its item.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C): a tokenizer name reaches it
transformers = pytest.importorskip("transformers")

from synapseml_torch import DataFrame
from synapseml_torch.core import batching as cb
from synapseml_torch.hf import HuggingFaceCausalLM
from synapseml_torch.hf import causal_lm as tcl
from synapseml_torch.models import convert_jax
from synapseml_torch.models.nets import llama as tl
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_torch.parallel import MeshConfig, default_llama_rules
from synapseml_tpu.core import DataFrame as JDataFrame
from synapseml_tpu.hf import causal_lm as jcl
from synapseml_tpu.models.flax_nets import llama as jl

VOCAB = 512
PROMPTS = ["hello world", "the quick brown fox jumps over the lazy dog again and again "
           "and again until the prompt spills into a second bucket of tokens", "a",
           "short one", "paged engines free their pages", "x y z"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast here, and idle OpenMP
    threads spinning after each small op would take cores from the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32_presets():
    """Both packages' presets in f32 compute (restored after the module)."""
    j_old, t_old = dict(jcl._ARCHS), dict(tcl._ARCHS)
    jcl._ARCHS["llama-tiny"] = lambda **kw: jl.llama_tiny(dtype=jnp.float32, **kw)
    tcl._ARCHS["llama-tiny"] = lambda **kw: tl.llama_tiny(dtype=torch.float32, **kw)
    yield
    jcl._ARCHS.clear()
    jcl._ARCHS.update(j_old)
    tcl._ARCHS.clear()
    tcl._ARCHS.update(t_old)


@pytest.fixture(scope="module")
def weights(f32_presets):
    jcfg = jl.llama_tiny(dtype=jnp.float32, vocab_size=VOCAB)
    init = jax.jit(jl.LlamaLM(jcfg).init)
    params = nn.unbox(init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    params = jax.tree.map(np.asarray, params)
    return params, convert_jax.llama_state_dict_from_flax(params)


def _kw(**over):
    kw = dict(model_name="llama-tiny", tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(),
              max_new_tokens=7, prompt_bucket=8, batch_size=2)
    kw.update(over)
    return kw


def _completions(df):
    return [np.asarray(r).tolist() for r in df.collect_column("completions")]


@pytest.mark.parametrize("engine,boost", [
    pytest.param("dense", {}, id="dense"),
    pytest.param("paged", {}, id="paged"),
    pytest.param("paged", dict(prefix_cache=True, draft_tokens=2), id="paged-prefix-spec"),
])
def test_completions_match_jax_stage(weights, engine, boost):
    params, sd = weights
    data = {"prompt": np.asarray(PROMPTS, dtype=object)}
    want = _completions(jcl.HuggingFaceCausalLM(**_kw(engine=engine, **boost),
                                                model_params=params)
                        .transform(JDataFrame.from_dict(data, num_partitions=2)))
    stage = HuggingFaceCausalLM(**_kw(engine=engine, **boost), model_params=sd, device="cpu")
    df = DataFrame.from_dict(data, num_partitions=2)
    got = _completions(stage.transform(df))
    assert got == want
    assert all(len(r) == 7 for r in got)
    assert _completions(stage.transform(df)) == got  # a second transform


def test_dense_and_paged_share_one_weight_copy_and_agree(weights):
    _, sd = weights
    df = DataFrame.from_dict({"prompt": np.asarray(PROMPTS, dtype=object)}, num_partitions=2)
    stage = HuggingFaceCausalLM(**_kw(), model_params=sd, device="cpu")
    dense = _completions(stage.transform(df))
    model, _ = stage._model_and_tokenizer()
    eng = stage._paged_engine(stage._effective_gen_cfg())
    assert eng.model is model  # the engine reads the stage's model and its weight copy
    paged = [eng.generate([p], 7)[0] for p in
             [HashingTokenizer(vocab_size=VOCAB).tokenize(t) for t in PROMPTS]]
    assert paged == dense


def test_callables_come_from_the_compiled_cache(weights):
    _, sd = weights
    cache = cb.get_compiled_cache()
    df = DataFrame.from_dict({"prompt": np.asarray(PROMPTS, dtype=object)}, num_partitions=2)
    stage = HuggingFaceCausalLM(**_kw(), model_params=sd, device="cpu")
    m0 = cache.miss_count("hf_causal_lm")
    stage.transform(df)
    first = cache.miss_count("hf_causal_lm") - m0
    stage.transform(df)
    assert 0 < first <= 4  # (batch bucket, prompt bucket) keys of the two partitions
    assert cache.miss_count("hf_causal_lm") - m0 == first
    stage.set(max_new_tokens=3)  # a cache key: the model and callables are dropped
    assert "_cache_model" not in stage.__dict__


def test_sampling_eos_chat_and_row_params(weights):
    _, sd = weights
    df = DataFrame.from_dict({"prompt": np.asarray(PROMPTS, dtype=object)})
    kw = _kw(model_params=sd, device="cpu", do_sample=True, temperature=0.8, top_k=10,
             top_p=0.9, seed=3)
    a = _completions(HuggingFaceCausalLM(**kw).transform(df))
    assert a == _completions(HuggingFaceCausalLM(**kw).transform(df))
    assert a != _completions(HuggingFaceCausalLM(**{**kw, "seed": 4}).transform(df))
    greedy = _completions(HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu"))
                          .transform(df))
    eos = greedy[0][2]
    cut = _completions(HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", eos_id=eos))
                       .transform(df))
    assert cut[0] == greedy[0][:2]
    rows = DataFrame.from_dict({"prompt": np.asarray(PROMPTS[:2], dtype=object),
                                "gen": np.asarray([{"max_new_tokens": 3}, None], dtype=object)})
    out = _completions(HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu",
                                                 generation_params_col="gen")).transform(rows))
    assert out == [greedy[0][:3], greedy[1]]
    chat = DataFrame.from_dict({"msgs": np.asarray(
        [[{"role": "user", "content": "hi there"}]], dtype=object)})
    got = _completions(HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu",
                                                 messages_col="msgs")).transform(chat))
    assert len(got[0]) == 7


def test_paged_transform_tolerates_zero_token_rows(weights):
    _, sd = weights

    class _ZeroForBlank(HashingTokenizer):
        def __call__(self, texts, **kw):
            enc = super().__call__(texts, **kw)
            enc["attention_mask"] = np.asarray(enc["attention_mask"]).copy()
            for i, t in enumerate(texts):
                if not t:
                    enc["attention_mask"][i, :] = 0
            return enc

    lm = HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", engine="paged",
                                   tokenizer=_ZeroForBlank(vocab_size=VOCAB), max_new_tokens=4))
    rows = _completions(lm.transform(DataFrame.from_dict(
        {"prompt": np.asarray(["hello there", "", "more text"], dtype=object)})))
    assert [len(r) for r in rows] == [4, 0, 4]


def test_engines_are_rebuilt_after_release_and_speculation_params(weights):
    _, sd = weights
    lm = HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", engine="paged",
                                   prefix_cache=True, draft_tokens=2))
    eff = lm._effective_gen_cfg()
    e1 = lm._paged_engine(eff)
    assert e1.prefix_cache is not None and e1.draft_tokens == 2 and e1._drafter is None
    e1.release()
    e2 = lm._paged_engine(eff)
    assert e2 is not e1 and not e2._released
    lm2 = HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", engine="paged",
                                    draft_tokens=2, drafter_ref="self:1"))
    assert lm2._paged_engine(eff).draft_layers == 1
    lm3 = HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", engine="paged",
                                    draft_tokens=2, drafter_ref="llama-tiny"))
    assert lm3._paged_engine(eff)._drafter is not None


def _params_of(cls):
    return {v.name: v.default for k in dir(cls)
            if type(v := getattr(cls, k)).__name__ in ("Param", "ComplexParam")}


def test_params_equal_the_jax_stage():
    want = _params_of(jcl.HuggingFaceCausalLM)
    got = _params_of(HuggingFaceCausalLM)
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("case,error", [
    # ported: a mesh of one process decodes as no mesh does; the paged engine
    # refuses a mesh with the JAX stage's error
    (dict(mesh_config=MeshConfig(data=1)), None),
    (dict(mesh_config=MeshConfig(data=1), partition_rules=default_llama_rules(),
          engine="paged"), (ValueError, "does not support mesh_config")),
    # the JAX stage's own errors: a directory without model.safetensors,
    # a tokenizer name that cannot be loaded (local files only: no download)
    (dict(model_name="."), (FileNotFoundError, "no model.safetensors")),
    (dict(tokenizer="meta-llama/Llama-2-7b-hf"), (ValueError, "could not load HuggingFace")),
], ids=["mesh_config", "partition_rules", "model_name-dir", "tokenizer-name"])
def test_unported_params_are_refused_with_their_item(case, error):
    """What cannot load raises the JAX stage's error; the mesh Params, once
    refused naming item 9, run (the mesh of one process as no mesh)."""
    stage = HuggingFaceCausalLM(**{**_kw(device="cpu"), **case})
    df = DataFrame.from_dict({"prompt": np.asarray(["a b"], dtype=object)})
    if error is None:
        want = _completions(HuggingFaceCausalLM(**_kw(device="cpu")).transform(df))
        assert _completions(stage.transform(df)) == want
        return
    with pytest.raises(error[0], match=error[1]):
        stage.transform(df)


def test_serving_engine_is_refused_with_its_item():
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        HuggingFaceCausalLM(device="cpu").serving_engine()


def test_default_device_is_the_card():
    stage = HuggingFaceCausalLM(**_kw())
    assert stage.get("device") == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage.transform(DataFrame.from_dict({"prompt": np.asarray(["a"], dtype=object)}))


def test_random_init_is_init_llama_params_seed_0(f32_presets):
    stage = HuggingFaceCausalLM(**_kw(device="cpu"))
    model, tok = stage._model_and_tokenizer()
    assert model.cfg == dataclasses.replace(tl.llama_tiny(dtype=torch.float32),
                                            vocab_size=VOCAB)
    want = convert_jax.init_llama_params(model.cfg, seed=0, device="cpu")
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


def test_save_load_round_trip(weights, tmp_path):
    from synapseml_torch import load_stage

    _, sd = weights
    df = DataFrame.from_dict({"prompt": np.asarray(PROMPTS[:3], dtype=object)})
    stage = HuggingFaceCausalLM(**_kw(model_params=sd, device="cpu", engine="paged"))
    want = _completions(stage.transform(df))
    stage.save(str(tmp_path / "lm"))
    loaded = load_stage(str(tmp_path / "lm"))
    assert isinstance(loaded, HuggingFaceCausalLM) and loaded.get("engine") == "paged"
    assert _completions(loaded.transform(df)) == want
