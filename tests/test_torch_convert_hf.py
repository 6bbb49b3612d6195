"""synapseml_torch's checkpoint reader and mappings against the JAX package's.

Each checkpoint directory is written by ``transformers`` in ``tmp_path``
from a seeded tiny config (no download; ``tests/_hf_checkpoints.py``), as
tests/test_convert_hf.py does, whose every case has its counterpart here or
in test_torch_convert_hf_stages.py (the stages):

* the port's reader is bitwise ``safetensors.numpy.load_file`` (every dtype
  numpy has, 0-d and empty tensors, sharded index files); BF16 as
  ``torch.bfloat16`` views bitwise the JAX reader's ``ml_dtypes.bfloat16``;
  the float8 types refused;
* each family's mapped state_dict (BERT classifier and encoder, ViT, Llama
  with GQA, tied or not, GPT-2, ResNet in HF and torchvision naming, heads
  seeded where missing) is bitwise the JAX mapping's tree carried through
  ``convert_jax``; f32 logits within 1e-5 of the Flax module on those
  weights; GPT-2 greedy tokens identical to the JAX decode and to
  ``transformers``;
* a Mixtral directory maps bitwise to the JAX mapping (routers, stacked
  experts, the dropless scatter config; logits and decoding in
  test_torch_mixtral.py); a bare BertModel's
  pooler and head are seeded as the JAX mapping seeds them; a pre-norm
  artifact without arch_config is detected and scored as the JAX model.
"""

import functools
import json

import numpy as np
import pytest
import torch

# imported at collection, before an ONNX test can leave its spec-less onnx
# stand-in in sys.modules (ROADMAP.md queue C)
transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hf_checkpoints import (bert_dir, bert_sd_from_flax, flax_np, gpt2_dir,  # noqa: E402
                             llama_dir, mixtral_dir, resnet_dir, same_state, save_ckpt,
                             to_module, vit_dir)

import synapseml_torch as pt  # noqa: E402
from synapseml_torch.hf import causal_lm as tcl  # noqa: E402
from synapseml_torch.models import convert_hf as T  # noqa: E402
from synapseml_torch.models import convert_jax  # noqa: E402
from synapseml_torch.models.nets import bert as tbert  # noqa: E402
from synapseml_torch.models.nets import llama as tl  # noqa: E402
from synapseml_torch.models.nets import resnet as tresnet  # noqa: E402
from synapseml_torch.models.nets import vit as tvit  # noqa: E402
from synapseml_torch.models.paged_engine import PagedDecodeEngine  # noqa: E402
from synapseml_torch.models import text as ttext  # noqa: E402
from synapseml_torch.models.tokenizer import HashingTokenizer  # noqa: E402
from synapseml_tpu.core import DataFrame as JDataFrame  # noqa: E402
from synapseml_tpu.models import convert_hf as J  # noqa: E402
from synapseml_tpu.models import text as jtext  # noqa: E402
from synapseml_tpu.models.flax_nets import bert as jbert  # noqa: E402
from synapseml_tpu.models.flax_nets import llama as jl  # noqa: E402
from synapseml_tpu.models.flax_nets import resnet as jresnet  # noqa: E402
from synapseml_tpu.models.flax_nets import vit as jvit  # noqa: E402
from synapseml_tpu.models.flax_nets.transformer import Encoder as JEncoder  # noqa: E402

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


# -------------------------------------------------------------------- reader

_ARRAYS = {
    "F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "U16": np.uint16,
    "U32": np.uint32, "U64": np.uint64, "BOOL": np.bool_,
}


@pytest.mark.parametrize("kind", sorted(_ARRAYS))
def test_reader_is_bitwise_safetensors_numpy(kind, tmp_path):
    rs = np.random.default_rng(len(kind))
    dt = np.dtype(_ARRAYS[kind])

    def arr(shape):
        if dt == np.bool_:
            return rs.integers(0, 2, shape).astype(bool)
        if dt.kind == "f":
            return rs.normal(size=shape).astype(dt)
        info = np.iinfo(dt)
        return rs.integers(info.min, info.max, shape, dtype=dt, endpoint=True)

    tensors = {"a": arr((3, 5)), "b.c": arr((2, 1, 4)), "scalar": arr(()), "empty": arr((0, 3)),
               "odd": arr((7,))}
    path = str(tmp_path / "x.safetensors")
    safetensors_numpy.save_file(tensors, path, metadata={"format": "np"})
    got, want = T.load_safetensors(path), safetensors_numpy.load_file(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_reader_reads_bf16_bitwise_as_the_jax_reader(tmp_path):
    """BF16, which numpy has no type for, comes back as torch.bfloat16 views
    of the mapped file, bitwise the JAX reader's ml_dtypes.bfloat16 values
    (subnormals, infinities, a NaN payload, -0.0 included), 0-d and empty
    tensors too, beside F32; the float8 types stay refused."""
    from safetensors.torch import save_file

    bits = np.random.default_rng(4).integers(0, 2 ** 16, (7, 9), dtype=np.uint16)
    bits[0, :5] = [0x0001, 0x7F80, 0xFF80, 0x7FC1, 0x8000]
    t = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
         "s": torch.tensor(1.5, dtype=torch.bfloat16), "e": torch.zeros(0, 3, dtype=torch.bfloat16),
         "x": torch.arange(4, dtype=torch.float32)}
    path = str(tmp_path / "bf.safetensors")
    save_file(t, path)
    got, want = T.load_safetensors(path), J.load_safetensors(path)
    assert sorted(got) == sorted(want) == sorted(t)
    for k in ("w", "s", "e"):
        assert got[k].dtype == torch.bfloat16 and want[k].dtype.name == "bfloat16", k
        assert tuple(got[k].shape) == want[k].shape, k
        assert np.array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                              want[k].view(np.uint16)), k
    assert got["x"].dtype == np.float32 and np.array_equal(got["x"], want["x"])
    # views of one mapping of the file, not widened copies: the tensors lie
    # as far apart in memory as their data_offsets in the file
    with open(path, "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    off = {k: header[k]["data_offsets"][0] for k in ("w", "x")}
    assert got["x"].ctypes.data - got["w"].data_ptr() == off["x"] - off["w"]
    save_file({"f8": torch.zeros(2, dtype=torch.float8_e4m3fn)}, str(tmp_path / "f8.safetensors"))
    with pytest.raises(TypeError, match="F8_E4M3.*float8_e4m3fn"):
        T.load_safetensors(str(tmp_path / "f8.safetensors"))


def test_sharded_safetensors_index(tmp_path, bert_ckpt):
    """model.safetensors.index.json shards, F32 / F16 / I64 across them, read
    bitwise as the JAX reader (safetensors.numpy) reads them."""
    d0, _ = bert_ckpt
    sd = dict(safetensors_numpy.load_file(d0 + "/model.safetensors"))
    sd["extra.f16"] = np.linspace(-3, 3, 11).astype(np.float16)
    sd["extra.i64"] = np.arange(-5, 6, dtype=np.int64) * (1 << 40)
    keys = sorted(sd)
    half = len(keys) // 2
    shard_map = {}
    for name, ks in [("model-00001-of-00002.safetensors", keys[:half]),
                     ("model-00002-of-00002.safetensors", keys[half:])]:
        safetensors_numpy.save_file({k: sd[k] for k in ks}, str(tmp_path / name))
        shard_map.update({k: name for k in ks})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": shard_map}, f)
    index = str(tmp_path / "model.safetensors.index.json")
    got, want = T.load_safetensors(index), J.load_safetensors(index)
    assert sorted(got) == sorted(want) == keys
    for k in keys:
        assert got[k].dtype == want[k].dtype == sd[k].dtype and np.array_equal(got[k], want[k])
    with open(tmp_path / "config.json", "w") as f:  # the directory loads as a whole
        json.dump({"model_type": "bert"}, f)
    cfg, got = T.load_checkpoint(str(tmp_path))
    assert cfg == {"model_type": "bert"} and sorted(got) == keys


def test_empty_directory_is_the_jax_error(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        J.load_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        T.load_checkpoint(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_shard_pretrained_params_is_refused_with_item_9():
    """Ported: the JAX function's contract, ``(mesh_ctx, placed)`` by the
    Llama table, on a mesh of one process (each leaf its own shard); a
    table that cannot place a leaf raises as the JAX package's does."""
    from synapseml_torch.parallel import MeshConfig, PartitionRules

    params = {"decoder.layers.0.attn.q.weight": np.arange(12, dtype=np.float32).reshape(4, 3),
              "decoder.norm.weight": np.ones(3, np.float32)}
    mesh, placed = T.shard_pretrained_params(params, MeshConfig(data=1))
    assert mesh.axis_sizes["data"] == 1 and set(placed) == set(params)
    for k, v in params.items():
        assert np.array_equal(placed[k].numpy(), v), k
    with pytest.raises(ValueError, match="rank"):
        T.shard_pretrained_params(params, MeshConfig(data=1),
                                  PartitionRules(rules=((r"norm", (None, None)),)))


# ------------------------------------------------------------------ families


@pytest.mark.parametrize("num_classes", [3, 5])
def test_bert_sequence_classifier_parity(bert_ckpt, num_classes):
    """num_classes 3 keeps the checkpoint's head; 5 seeds a new one as the
    JAX mapping does."""
    d, tmodel = bert_ckpt
    jcfg, jparams = J.pretrained_text_classifier(d, num_classes=num_classes, seed=4,
                                                 dtype=jnp.float32)
    cfg, sd = T.pretrained_text_classifier(d, num_classes=num_classes, seed=4,
                                           dtype=torch.float32)
    same_state(sd, convert_jax.bert_state_dict_from_flax(flax_np(jparams)))
    assert (cfg.n_heads, cfg.hidden, cfg.norm_position) == (jcfg.n_heads, jcfg.hidden, "post")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 97, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    want = np.asarray(jbert.BertClassifier(jcfg, num_classes=num_classes).apply(
        {"params": jparams}, ids, mask))
    module = to_module(tbert.BertClassifier(cfg, num_classes=num_classes), sd)
    with torch.no_grad():
        got = module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if num_classes == 3:  # the checkpoint's own head: the HF model's logits
        with torch.no_grad():
            hf = tmodel(input_ids=torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask).long()).logits.numpy()
        np.testing.assert_allclose(got, hf, atol=2e-4, rtol=0)


def test_bert_encoder_parity(bert_ckpt):
    """The headless encoder (HuggingFaceSentenceEmbedder's backbone)."""
    from synapseml_torch.hf.embedder import BertEncoder
    from synapseml_tpu.models.flax_nets.bert import BertEmbeddings

    d, _ = bert_ckpt
    jcfg, jparams = J.pretrained_encoder(d, dtype=jnp.float32)
    cfg, sd = T.pretrained_encoder(d, dtype=torch.float32)
    assert not any(k.startswith(("pooler.", "classifier.")) for k in sd)
    same_state(sd, bert_sd_from_flax(flax_np(jparams)))

    class Net(nn.Module):
        @nn.compact
        def __call__(self, ids, mask):
            x = BertEmbeddings(jcfg, name="embeddings")(ids)
            return JEncoder(jcfg, name="encoder")(x, mask[:, None, None, :].astype(bool))

    ids = np.random.default_rng(1).integers(0, 97, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[0, 5:] = 0
    want = np.asarray(Net().apply({"params": jparams}, ids, mask))
    with torch.no_grad():
        got = to_module(BertEncoder(cfg), sd)(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("num_classes", [5, 7])
def test_vit_parity(tmp_path, num_classes):
    d, tmodel = vit_dir(tmp_path)
    jkind, jinfo, jvars = J.pretrained_vision(d, num_classes=num_classes, seed=2,
                                              dtype=jnp.float32)
    kind, info, variables = T.pretrained_vision(d, num_classes=num_classes, seed=2,
                                                dtype=torch.float32)
    assert (kind, info["patch"]) == (jkind, jinfo["patch"]) == ("vit", 8)
    same_state(variables["params"], convert_jax.vit_state_dict_from_flax(flax_np(jvars["params"])))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.ViTClassifier(jinfo["cfg"], num_classes=num_classes,
                                         patch=8).apply(jvars, x))
    module = to_module(tvit.ViTClassifier(info["cfg"], num_classes=num_classes, patch=8),
                        variables["params"])
    with torch.no_grad():
        got = module(x=torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if num_classes == 5:
        with torch.no_grad():
            hf = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()
        np.testing.assert_allclose(got, hf, atol=2e-4, rtol=0)


def _greedy_both(jcfg, jparams, cfg, sd, prompts, n):
    """(JAX greedy_generate tokens, port dense tokens, port paged tokens)."""
    P = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), P), np.int32)
    mask = np.zeros_like(ids)
    for i, p in enumerate(prompts):
        ids[i, :len(p)], mask[i, :len(p)] = p, 1
    want = np.asarray(jl.greedy_generate(jl.LlamaLM(jcfg, decode=True), jparams,
                                         jnp.asarray(ids), n, prompt_mask=jnp.asarray(mask)))
    model = tcl.load_llama(cfg, sd, "cpu")
    dense = tl.generate(model, torch.from_numpy(ids), n, prompt_mask=torch.from_numpy(mask))
    if cfg.learned_pos:  # GPT-2: the paged engine takes the RoPE family only, as the JAX one
        with pytest.raises(ValueError, match="paged engine supports"):
            PagedDecodeEngine(model, block_len=8, max_slots=len(prompts)).generate(prompts, n)
        paged = None
    else:
        paged = PagedDecodeEngine(model, block_len=8, max_slots=len(prompts)).generate(prompts, n)
    return want[:, P:].tolist(), dense.numpy()[:, P:].tolist(), paged


@pytest.mark.parametrize("tie", [False, True], ids=["lm_head", "tied"])
def test_llama_parity_gqa(tmp_path, tie):
    d, tmodel = llama_dir(tmp_path, tie=tie)
    jcfg, jparams = J.pretrained_causal_lm(d, dtype=jnp.float32)
    cfg, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    assert (cfg.n_heads, cfg.kv_heads, cfg.causal) == (jcfg.n_heads, jcfg.kv_heads, True) \
        == (4, 2, True)
    same_state(sd, convert_jax.llama_state_dict_from_flax(flax_np(jparams)))
    ids = np.random.default_rng(3).integers(0, 89, (2, 12)).astype(np.int32)
    want = np.asarray(jl.LlamaLM(jcfg).apply({"params": jparams}, ids))
    with torch.no_grad():
        got = tcl.load_llama(cfg, sd, "cpu")(torch.from_numpy(ids)).numpy()
        hf = tmodel(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, hf, atol=5e-4, rtol=0)
    # greedy tokens, dense and paged: test_causal_lm_from_checkpoint_dir


def test_gpt2_parity(tmp_path):
    """Learned positions, LayerNorm pre-norm with biases, the fused qkv
    Conv1D split, the tied LM head."""
    d, tmodel = gpt2_dir(tmp_path)
    jcfg, jparams = J.pretrained_causal_lm(d, dtype=jnp.float32)
    cfg, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    assert cfg.learned_pos and cfg.norm == "layernorm" and cfg.causal
    assert cfg.act == "gelu_tanh" and not cfg.use_rope and not cfg.gated_mlp
    same_state(sd, convert_jax.llama_state_dict_from_flax(flax_np(jparams)))
    ids = np.random.default_rng(8).integers(0, 93, (2, 10)).astype(np.int32)
    want = np.asarray(jl.LlamaLM(jcfg).apply({"params": jparams}, ids))
    with torch.no_grad():
        got = tcl.load_llama(cfg, sd, "cpu")(torch.from_numpy(ids)).numpy()
        hf = tmodel(torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, hf, atol=5e-4, rtol=0)


def test_gpt2_greedy_decode_matches_torch_and_jax(tmp_path):
    d, tmodel = gpt2_dir(tmp_path, seed=9, vocab=61)
    jcfg, jparams = J.pretrained_causal_lm(d, dtype=jnp.float32)
    cfg, sd = T.pretrained_causal_lm(d, dtype=torch.float32)
    prompt = np.random.default_rng(10).integers(0, 61, (1, 6)).astype(np.int32)
    want_t, dense, paged = _greedy_both(jcfg, jparams, cfg, sd, prompt.tolist(), 8)
    hf = tmodel.generate(torch.from_numpy(prompt).long(), max_new_tokens=8, do_sample=False,
                         pad_token_id=0).numpy()[:, 6:].tolist()
    assert dense == want_t == hf and paged is None


def test_mixtral_maps_bitwise_to_the_jax_mapping(tmp_path):
    """A Mixtral directory: the config's dropless scatter MoE (cf = E / k)
    as the JAX mapping's, and the state dict (routers as they are, w1 / w3
    / w2 stacked over the experts into [E, in, out], zero biases) bitwise
    the JAX tree carried through convert_jax."""
    d = mixtral_dir(tmp_path / "mixtral")
    jcfg, jparams = J.pretrained_causal_lm(d)
    cfg, sd = T.pretrained_causal_lm(d)
    for f in ("moe_experts", "moe_top_k", "moe_capacity_factor", "moe_dispatch", "n_layers",
              "hidden", "mlp_dim", "kv_heads", "rope_theta", "max_len"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.moe_dispatch) == (2, 2, "scatter")
    same_state(sd, convert_jax.llama_state_dict_from_flax(flax_np(jparams)))
    assert sd["decoder.layers.0.mlp.w_up"].shape == (2, 16, 32)
    assert sd["decoder.layers.0.mlp.w_dn"].shape == (2, 32, 16)


def test_resnet_parity_hf(tmp_path):
    d, tmodel = resnet_dir(tmp_path)
    jkind, jarch, jvars = J.pretrained_vision(d, num_classes=4)
    kind, arch, variables = T.pretrained_vision(d, num_classes=4)
    assert kind == jkind == "resnet" and arch == jarch
    same_state(variables["params"], convert_jax.resnet_state_dict_from_flax(flax_np(jvars["params"])))
    same_state(variables["batch_stats"],
          convert_jax.resnet_state_dict_from_flax(batch_stats=flax_np(jvars["batch_stats"])))
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jresnet.ResNet(num_classes=4, dtype=jnp.float32, **jarch).apply(jvars, x))
    module = to_module(tresnet.ResNet(num_classes=4, dtype=torch.float32, **arch),
                        {**variables["params"], **variables["batch_stats"]})
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a mis-sized head is seeded as the JAX mapping seeds it
    _, _, jnew = J.pretrained_vision(d, num_classes=3, seed=6)
    _, _, new = T.pretrained_vision(d, num_classes=3, seed=6)
    same_state(new["params"], convert_jax.resnet_state_dict_from_flax(flax_np(jnew["params"])))


def test_torchvision_style_resnet_keys(tmp_path):
    _, tmodel = resnet_dir(tmp_path, seed=4)
    hf_sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    tv_sd = T._hf_resnet_to_torchvision_keys(hf_sd)
    assert tv_sd.keys() == J._hf_resnet_to_torchvision_keys(hf_sd).keys()
    assert "conv1.weight" in tv_sd and "layer2.0.downsample.0.weight" in tv_sd
    for src in (hf_sd, tv_sd):
        got, want = T.resnet_variables_from_torch(src), J.resnet_variables_from_torch(src)
        same_state(got["params"], convert_jax.resnet_state_dict_from_flax(flax_np(want["params"])))
        same_state(got["batch_stats"],
              convert_jax.resnet_state_dict_from_flax(batch_stats=flax_np(want["batch_stats"])))
    module = to_module(tresnet.ResNet(stage_sizes=(1, 1), block="bottleneck", width=8,
                                       num_classes=4, dtype=torch.float32),
                        {**got["params"], **got["batch_stats"]})
    x = np.random.default_rng(5).normal(size=(1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jresnet.ResNet(stage_sizes=(1, 1), block="bottleneck", width=8,
                                     num_classes=4, dtype=jnp.float32).apply(
        J.resnet_variables_from_torch(tv_sd), x))
    with torch.no_grad():
        np.testing.assert_allclose(module(torch.from_numpy(x)).numpy(), want, atol=TOL, rtol=0)


def test_bert_model_without_head_seeds_pooler_and_head(tmp_path):
    """A bare BertModel (a pooler, no classifier) and one without its pooler:
    the missing parts seeded as the JAX mapping seeds them."""
    from transformers import BertConfig, BertModel

    cfg = BertConfig(vocab_size=40, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=32)
    torch.manual_seed(3)
    d = save_ckpt(BertModel(cfg, add_pooling_layer=True), tmp_path / "with", cfg)
    _, sd = T.load_checkpoint(d)
    for drop_pooler in (False, True):
        src = {k: v for k, v in sd.items() if not (drop_pooler and k.startswith("pooler."))}
        got = T.bert_params_from_hf(src, num_classes=4, seed=9)
        want = J.bert_params_from_hf(src, num_classes=4, seed=9)
        same_state(got, convert_jax.bert_state_dict_from_flax(flax_np(want)))


def test_legacy_prenorm_artifact_detection():
    """A DeepTextModel saved before the post-norm change (pre-norm layout, no
    arch_config) evaluates with the architecture it was trained as, as the
    JAX model does (presets patched to f32 on both sides)."""
    import dataclasses

    tok = HashingTokenizer(vocab_size=64)
    old_cfg = dataclasses.replace(jbert.bert_tiny(vocab_size=64), norm_position="pre",
                                  norm_eps=1e-6, act="gelu_tanh", dtype=jnp.float32)
    module = jbert.BertClassifier(old_cfg, num_classes=2)
    params = flax_np(module.init(jax.random.PRNGKey(0), np.ones((1, 8), np.int32),
                             np.ones((1, 8), np.int32))["params"])
    assert "LayerNorm_0" in params["encoder"]  # pre-norm final-norm layout
    sd = convert_jax.bert_state_dict_from_flax(params)
    assert "encoder.norm.weight" in sd
    fixed = T.legacy_prenorm_fixup(tbert.bert_tiny(vocab_size=64), sd)
    assert (fixed.norm_position, fixed.norm_eps, fixed.act) == ("pre", 1e-6, "gelu_tanh")
    assert T.legacy_prenorm_fixup(tbert.bert_tiny(), {}) == tbert.bert_tiny()
    rows = [{"text": "hello world"}, {"text": "good film"}]
    kw = dict(arch_config=None, tokenizer_config=tok.to_config(), checkpoint="bert-tiny",
              num_classes=2, max_token_len=8, batch_size=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtext._ARCHS, "bert-tiny", functools.partial(jbert.bert_tiny,
                                                                dtype=jnp.float32))
        mp.setitem(ttext._ARCHS, "bert-tiny", functools.partial(tbert.bert_tiny,
                                                                dtype=torch.float32))
        want = jtext.DeepTextModel(model_params=params, **kw).transform(
            JDataFrame.from_rows(rows)).collect_column("scores")
        got = ttext.DeepTextModel(model_params=sd, device="cpu", **kw).transform(
            pt.DataFrame.from_rows(rows)).collect_column("scores")
    np.testing.assert_allclose(np.stack(list(got)), np.stack(list(want)), atol=TOL)
