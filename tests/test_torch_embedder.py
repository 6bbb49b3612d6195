"""synapseml_torch's HuggingFaceSentenceEmbedder against the JAX package's.

Both stages embed the same multi-partition DataFrame with the same weights:
a ``bert-tiny`` preset holding the Flax init of the JAX stage's encoder
(bridged to the port's state_dict), and a BERT checkpoint directory written
by ``transformers`` (no download). Embeddings agree within 1e-5 for mean
and CLS pooling, with and without L2 normalisation, over partitions whose
batches pad to different rungs (padded rows keep mask 1). Each (bucket,
seq_len) takes one CompiledCache callable, none on a repeat; a preset
without weights draws the Flax initialisers' distribution with numpy; the
Params are the JAX stage's plus ``device``; ``mesh_config`` is refused
naming queue A item 9.
"""

import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C)
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hf_checkpoints import bert_dir, bert_sd_from_flax, flax_np  # noqa: E402

import synapseml_torch as pt  # noqa: E402
from synapseml_torch.core import batching as tcb  # noqa: E402
from synapseml_torch.hf import HuggingFaceSentenceEmbedder  # noqa: E402
from synapseml_torch.hf import embedder as temb  # noqa: E402
from synapseml_torch.models.nets import bert as tbert  # noqa: E402
from synapseml_torch.models.tokenizer import HashingTokenizer  # noqa: E402
from synapseml_tpu.core import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.hf import embedder as jemb  # noqa: E402
from synapseml_tpu.models.flax_nets import bert as jbert  # noqa: E402

VOCAB, TOL = 512, 1e-5
_WORDS = "alpha beta gamma delta the a of film good bad lazy dog quick fox".split()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts(n, seed, words=(1, 14)):
    rs = np.random.default_rng(seed)
    return [" ".join(rs.choice(_WORDS, size=int(rs.integers(*words)))) for _ in range(n)]


def _parts():
    """Two partitions of 5 short and 11 long rows (sequence rungs 8 and 24):
    with batch_size 4, chunks of 4 and tails of 1 and 3, padded to their
    rungs."""
    return [{"text": np.asarray(_texts(5, seed=1, words=(1, 6)), dtype=object)},
            {"text": np.asarray(_texts(11, seed=2, words=(10, 30)), dtype=object)}]


@pytest.fixture(scope="module")
def preset_weights():
    cfg = jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32)
    enc = jemb._BertEncoder(cfg)
    params = flax_np(jax.jit(enc.net.init)(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                                           jnp.ones((1, 8), jnp.int32))["params"])
    return params, bert_sd_from_flax(params)


def _kw(**over):
    kw = dict(model_name="bert-tiny", tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(),
              max_token_len=24, batch_size=4)
    kw.update(over)
    return kw


def _embeddings(df):
    return np.stack(list(df.collect_column("embeddings")))


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("normalize", [False, True])
def test_preset_embeddings_match_jax(preset_weights, pooling, normalize):
    params, sd = preset_weights
    want = _embeddings(jemb.HuggingFaceSentenceEmbedder(
        **_kw(pooling=pooling, normalize=normalize), model_params=params).transform(
        JDataFrame([dict(p) for p in _parts()])))
    stage = HuggingFaceSentenceEmbedder(**_kw(pooling=pooling, normalize=normalize),
                                        model_params=sd, device="cpu")
    got = _embeddings(stage.transform(pt.DataFrame([dict(p) for p in _parts()])))
    assert got.shape == want.shape == (16, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_checkpoint_directory_embeddings_match_jax(tmp_path, pooling):
    d, tmodel = bert_dir(tmp_path / "bert")
    kw = dict(model_name=d, tokenizer=HashingTokenizer(vocab_size=97).to_config(),
              max_token_len=16, batch_size=4, pooling=pooling, normalize=True)
    want = _embeddings(jemb.HuggingFaceSentenceEmbedder(**kw).transform(
        JDataFrame([dict(p) for p in _parts()])))
    stage = HuggingFaceSentenceEmbedder(**kw, device="cpu")
    got = _embeddings(stage.transform(pt.DataFrame([dict(p) for p in _parts()])))
    assert got.shape == (16, 48)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if pooling == "cls":  # the checkpoint's own encoder: transformers' CLS state
        enc = HashingTokenizer(vocab_size=97)(list(_parts()[0]["text"]), max_len=16)
        with torch.no_grad():
            h = tmodel.bert(input_ids=torch.from_numpy(enc["input_ids"]).long(),
                            attention_mask=torch.from_numpy(enc["attention_mask"]).long()
                            ).last_hidden_state[:, 0].numpy()
        h /= np.linalg.norm(h, axis=-1, keepdims=True)
        np.testing.assert_allclose(got[:5], h, atol=2e-4, rtol=0)


def test_padded_rows_keep_mask_one_and_one_callable_per_bucket(preset_weights, monkeypatch):
    _, sd = preset_weights
    stage = HuggingFaceSentenceEmbedder(**_kw(), model_params=sd, device="cpu")
    seen = []
    real = HuggingFaceSentenceEmbedder._embed_for

    def spy(self, bucket, seq_len):
        fn = real(self, bucket, seq_len)

        def run(ids, mask):
            seen.append(mask.copy())
            return fn(ids, mask)
        return run

    monkeypatch.setattr(HuggingFaceSentenceEmbedder, "_embed_for", spy)
    cache = tcb.get_compiled_cache()
    m0 = cache.miss_count("hf_embedder")
    df = pt.DataFrame([dict(p) for p in _parts()])
    first = _embeddings(stage.transform(df))
    misses = cache.miss_count("hf_embedder") - m0
    shapes = {m.shape for m in seen}
    assert misses == len(shapes) >= 2  # one per (bucket, seq_len)
    second = _embeddings(stage.transform(df))
    assert cache.miss_count("hf_embedder") - m0 == misses  # none on the repeat
    assert np.array_equal(first, second)
    # the 5-row partition's tail: 1 real row padded to its rung, mask 1 there
    tail = seen[1]
    assert tail.shape[0] > 1 and np.all(tail[1:] == 1)
    # a row's embedding does not depend on the rows batched with it
    alone = _embeddings(stage.transform(pt.DataFrame.from_dict(
        {"text": np.asarray(list(_parts()[1]["text"][:1]), dtype=object)})))
    np.testing.assert_allclose(alone[0], first[5], atol=TOL, rtol=0)


def test_preset_init_has_the_flax_distribution():
    """No weights: a preset's encoder draws the JAX initialisers with numpy
    from seed 0 (init_flax_bert_params), not PRNGKey(0) bits."""
    stage = HuggingFaceSentenceEmbedder(**_kw(), device="cpu")
    stage.transform(pt.DataFrame.from_dict({"text": np.asarray(["a b"], dtype=object)}))
    cfg = tbert.bert_tiny(vocab_size=VOCAB, dtype=torch.float32)
    got = temb._init_encoder(cfg)
    flax = bert_sd_from_flax(flax_np(jax.jit(jemb._BertEncoder(
        jbert.bert_tiny(vocab_size=VOCAB, dtype=jnp.float32)).net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in flax.items()}
    for name in got:
        g, w = got[name], flax[name]
        if np.all(w == w.flat[0]):  # biases 0, norm scales 1
            assert np.array_equal(g, w), name
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, name
            assert np.abs(g).max() <= 1.5 * np.abs(w).max(), name
    again = HuggingFaceSentenceEmbedder(**_kw(), model_params=got, device="cpu")
    x = pt.DataFrame.from_dict({"text": np.asarray(["a b", "c"], dtype=object)})
    assert np.array_equal(_embeddings(stage.transform(x)), _embeddings(again.transform(x)))


def _params_of(cls):
    return {v.name: v.default for k in dir(cls)
            if type(v := getattr(cls, k)).__name__ in ("Param", "ComplexParam")}


def test_params_equal_the_jax_stage_and_unported_ones_are_refused(preset_weights, tmp_path):
    got = _params_of(HuggingFaceSentenceEmbedder)
    assert got.pop("device") == "cuda"
    assert got == _params_of(jemb.HuggingFaceSentenceEmbedder)
    df = pt.DataFrame.from_dict({"text": np.asarray(["a"], dtype=object)})
    from synapseml_torch.parallel import MeshConfig

    _, sd0 = preset_weights
    plain = _embeddings(HuggingFaceSentenceEmbedder(**_kw(), model_params=sd0,
                                                    device="cpu").transform(df))
    sharded = _embeddings(HuggingFaceSentenceEmbedder(**_kw(), model_params=sd0,
                                                      mesh_config=MeshConfig(data=1),
                                                      device="cpu").transform(df))
    assert np.array_equal(sharded, plain)  # mesh_config, once refused: one process
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HuggingFaceSentenceEmbedder(**_kw()).transform(df)
    _, sd = preset_weights
    stage = HuggingFaceSentenceEmbedder(**_kw(), model_params=sd, device="cpu")
    before = _embeddings(stage.transform(df))
    stage.save(str(tmp_path / "e"))
    after = _embeddings(pt.load_stage(str(tmp_path / "e")).transform(df))
    assert np.array_equal(before, after)
