"""Mixtral checkpoint directories through synapseml_torch against the JAX
package and ``transformers``.

The directory is written by ``transformers`` in ``tmp_path`` (no download)
from tests/test_convert_hf.py's tiny Mixtral config (4 experts, top-2, GQA
4/2, 2 layers; ``tests/_hf_checkpoints.py::mixtral4_dir``):

* the port's state dict is bitwise the JAX mapping's through ``convert_jax``
  (F32, and BF16 read without widening, bitwise ``ml_dtypes.bfloat16``);
* f32 ``LlamaLM`` logits within 1e-5 of the JAX ``LlamaLM`` and of
  ``MixtralForCausalLM``;
* greedy tokens identical to the JAX package's through
  ``HuggingFaceCausalLM``, dense and paged, and to ``transformers``;
* the paged functions within 1e-5 of the JAX ones, pages too;
* ``load_llama`` holds the experts in the compute dtype and the routers in
  f32, bitwise the per-call cast.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C)
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hf_checkpoints import flax_np, mixtral4_dir, same_state  # noqa: E402

import synapseml_torch as pt  # noqa: E402
from synapseml_torch.hf import causal_lm as tcl  # noqa: E402
from synapseml_torch.models import convert_hf as T  # noqa: E402
from synapseml_torch.models import convert_jax  # noqa: E402
from synapseml_torch.models.nets import llama as tl  # noqa: E402
from synapseml_torch.models.nets import transformer as tt  # noqa: E402
from synapseml_torch.models.tokenizer import HashingTokenizer  # noqa: E402
from synapseml_tpu.core import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.hf import causal_lm as jcl  # noqa: E402
from synapseml_tpu.models import convert_hf as J  # noqa: E402
from synapseml_tpu.models.flax_nets import llama as jl  # noqa: E402

TOL = 1e-5
VOCAB = 97


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """(directory, transformers model, JAX cfg, JAX params, port cfg, port
    state dict), all f32."""
    d, tmodel = mixtral4_dir(tmp_path_factory.mktemp("mixtral"))
    jcfg, jparams = J.pretrained_causal_lm(d, dtype=jnp.float32)
    cfg, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    return d, tmodel, jcfg, jparams, cfg, sd


def test_state_dict_is_the_jax_mapping(mixtral):
    _, _, jcfg, jparams, cfg, sd = mixtral
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.moe_dispatch, cfg.gated_mlp) == (4, 2, "scatter",
                                                                                True)
    assert cfg.moe_capacity_factor == jcfg.moe_capacity_factor == 2.0  # dropless: C = S
    same_state(sd, convert_jax.llama_state_dict_from_flax(flax_np(jparams)))


def test_logits_match_jax_and_transformers(mixtral):
    _, tmodel, jcfg, jparams, cfg, sd = mixtral
    ids = np.random.default_rng(6).integers(0, VOCAB, (2, 10)).astype(np.int32)
    want = np.asarray(jax.jit(lambda i: jl.LlamaLM(jcfg).apply({"params": jparams}, i))(ids))
    model = tcl.load_llama(cfg, sd, "cpu")
    assert isinstance(model.decoder.layers[1].mlp, tt.MoEBlock)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        hf = tmodel(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, hf, atol=TOL, rtol=0)


_PROMPTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a",
            "paged engines free their pages", "experts route every token"]


@pytest.fixture
def f32_causal_lm(monkeypatch):
    monkeypatch.setattr(J, "pretrained_causal_lm",
                        functools.partial(J.pretrained_causal_lm, dtype=jnp.float32))
    monkeypatch.setattr(tcl, "pretrained_causal_lm",
                        functools.partial(T.pretrained_causal_lm, dtype=torch.float32))


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_causal_lm_greedy_tokens_match_jax(mixtral, f32_causal_lm, engine):
    """HuggingFaceCausalLM(model_name=<Mixtral dir>) over two partitions:
    completions identical to the JAX stage's; the model holds the directory's
    weights."""
    d = mixtral[0]
    kw = dict(model_name=d, tokenizer=HashingTokenizer(vocab_size=VOCAB).to_config(),
              max_new_tokens=6, prompt_bucket=8, batch_size=2, engine=engine)
    data = {"prompt": np.asarray(_PROMPTS, dtype=object)}
    want = jcl.HuggingFaceCausalLM(**kw).transform(JDataFrame.from_dict(data, num_partitions=2))
    stage = tcl.HuggingFaceCausalLM(**kw, device="cpu")
    got = stage.transform(pt.DataFrame.from_dict(data, num_partitions=2))
    got, want = ([np.asarray(r).tolist() for r in df.collect_column("completions")]
                 for df in (got, want))
    assert got == want and all(len(r) == 6 for r in got)
    model, _ = stage._model_and_tokenizer()
    _, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    assert all(torch.equal(v, torch.from_numpy(np.array(sd[k])))
               for k, v in model.state_dict().items())


def test_greedy_generate_matches_transformers(mixtral):
    """tests/test_convert_hf.py's decode check for the port: greedy tokens
    through the KV cache (the MoE layers on one-token slices) identical to
    MixtralForCausalLM.generate."""
    _, tmodel, _, _, cfg, sd = mixtral
    ids = np.random.default_rng(6).integers(0, VOCAB, (1, 10))
    with torch.no_grad():
        want = tmodel.generate(torch.from_numpy(ids).long(), max_new_tokens=5,
                               do_sample=False, num_beams=1).numpy()
    got = tl.greedy_generate(tcl.load_llama(cfg, sd, "cpu"), torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _pages(cfg, n_blocks, bl, seed):
    rs = np.random.default_rng(seed)
    shape = (n_blocks, bl, cfg.kv_heads, cfg.head_dim)
    return tuple(rs.standard_normal(shape).astype(np.float32) for _ in range(cfg.n_layers))


def _padded(lens, P, seed):
    rs = np.random.default_rng(seed)
    ids = np.zeros((len(lens), P), np.int32)
    mask = np.zeros((len(lens), P), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.integers(2, VOCAB, n)
        mask[i, :n] = 1
    return ids, mask


def test_paged_functions_match_jax(mixtral):
    """paged_prefill, paged_extend, paged_decode_step and paged_verify with
    MoE layers on one pool (inactive slots route too, as in the JAX
    engine): logits within 1e-5 of JAX after each, every page but the
    trash page equal."""
    _, _, jcfg, params, cfg, sd = mixtral
    model = tcl.load_llama(cfg, sd, "cpu")
    bl, n_blocks, max_blocks = 8, 12, 5
    kp, vp = _pages(jcfg, n_blocks, bl, 0), _pages(jcfg, n_blocks, bl, 1)
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    tables = np.zeros((3, max_blocks), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [2, 9]
    tables[2, :4] = [4, 5, 6, 8]
    Tn = lambda a: torch.from_numpy(np.asarray(a)).long()  # noqa: E731

    def check(got, want, pages):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        jk, jv = pages
        for a, b in zip(tk + tv, list(jk) + list(jv)):
            np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:], atol=TOL, rtol=0)

    ids, mask = _padded([13, 5, 16], 16, seed=2)
    want, kp, vp = jax.jit(lambda *a: jl.paged_prefill(jcfg, bl, params, *a))(
        ids, mask, tables, kp, vp)
    check(tl.paged_prefill(model, bl, Tn(ids), Tn(mask), Tn(tables), tk, tv), want, (kp, vp))

    sfx, smask = _padded([4, 2, 6], 8, seed=3)
    start = np.asarray([13, 5, 16], np.int32)
    want, kp, vp = jax.jit(lambda *a: jl.paged_extend(jcfg, bl, params, *a))(
        sfx, smask, start, tables, kp, vp)
    check(tl.paged_extend(model, bl, Tn(sfx), Tn(smask), Tn(start), Tn(tables), tk, tv), want,
          (kp, vp))

    tok = np.asarray([7, 11, 3], np.int32)
    lens = np.asarray([17, 7, 22], np.int32)
    active = np.asarray([True, False, True])
    want, kp, vp = jax.jit(lambda *a: jl.paged_decode_step(jcfg, bl, params, *a))(
        tok, lens, active, tables, kp, vp)
    check(tl.paged_decode_step(model, bl, Tn(tok), Tn(lens), Tn(active), Tn(tables), tk, tv),
          want, (kp, vp))

    win = np.asarray([[5, 6, 7], [8, 9, 10], [11, 12, 13]], np.int32)
    lens = np.asarray([18, 7, 23], np.int32)
    want, kp, vp = jax.jit(lambda *a: jl.paged_verify(jcfg, bl, params, *a))(
        win, lens, active, tables, kp, vp)
    check(tl.paged_verify(model, bl, Tn(win), Tn(lens), Tn(active), Tn(tables), tk, tv), want,
          (kp, vp))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_bf16_directory_reads_bitwise_and_loads(tmp_path, mixtral):
    """A BF16 Mixtral directory: every tensor of the port's mapping a
    torch.bfloat16 tensor bitwise the JAX mapping's ml_dtypes.bfloat16 leaf
    (the stacked experts and the zero biases included); load_llama from it
    is bitwise load_llama from the same values widened to f32 on the host."""
    d, _ = mixtral4_dir(tmp_path / "bf16", dtype=torch.bfloat16)
    _, jparams = J.pretrained_causal_lm(d)
    cfg, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    want = convert_jax.llama_state_dict_from_flax(flax_np(jparams))
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == torch.bfloat16 and want[k].dtype.name == "bfloat16", k
        assert tuple(v.shape) == want[k].shape, k
        assert np.array_equal(_bits(v), _bits(want[k])), k
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, VOCAB, (2, 9)))
    with torch.no_grad():
        got = tcl.load_llama(cfg, sd, "cpu")(ids)
        widened = tcl.load_llama(cfg, {k: v.float() for k, v in sd.items()}, "cpu")(ids)
    assert torch.equal(got, widened)


def test_load_llama_casts_experts_and_keeps_routers_f32(mixtral):
    """bf16 compute: load_llama holds each MoE layer's expert tensors in
    bf16 (cast once) and its router in f32, as the JAX module keeps it;
    logits bitwise the per-call cast's; the state dict keeps its tensors."""
    _, _, _, _, cfg, sd = mixtral
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    with torch.device("meta"):
        plain = tl.LlamaLM(cfg)
    plain.load_state_dict(sd, assign=True)
    cast = tcl.load_llama(cfg, sd, "cpu")
    for name, v in cast.state_dict().items():
        compute = name.startswith("decoder.layers.") and (
            ".attn." in name or (".mlp." in name and ".router." not in name))
        assert v.dtype == (torch.bfloat16 if compute else torch.float32), name
    assert all(v.dtype == torch.float32 for v in sd.values())
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, VOCAB, (2, 12)))
    with torch.no_grad():
        assert torch.equal(cast(ids), plain(ids))
