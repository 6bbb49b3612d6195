"""Seeded tiny HuggingFace checkpoint directories for the port's ingestion
tests (written by ``transformers`` into a test's tmp_path, no download), and
the comparisons those tests share."""

import jax
import numpy as np
import torch
from flax import linen as nn

from synapseml_torch.models import convert_jax


def flax_np(tree):
    return jax.tree.map(np.asarray, nn.unbox(tree))


def save_ckpt(model, d, config):
    model.eval()
    model.save_pretrained(d, safe_serialization=True)
    config.save_pretrained(d)
    return str(d)


def same_state(got: dict, want: dict) -> None:
    """Bitwise equal state_dicts, dtypes included (both mappings keep the
    file's dtype)."""
    assert sorted(got) == sorted(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def bert_sd_from_flax(params: dict) -> dict:
    """``convert_jax.bert_state_dict_from_flax`` of a tree that may lack the
    pooler and the head (the encoder's)."""
    dummy = {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
    out = convert_jax.bert_state_dict_from_flax({"pooler": dummy, "classifier": dummy,
                                                 **params})
    return {k: v for k, v in out.items() if k.split(".")[0] in params}


def to_module(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module.eval()


def bert_dir(d, seed=0, labels=3, vocab=97):
    from transformers import BertConfig, BertForSequenceClassification

    torch.manual_seed(seed)
    cfg = BertConfig(vocab_size=vocab, hidden_size=48, num_hidden_layers=2,
                     num_attention_heads=3, intermediate_size=96,
                     max_position_embeddings=64, num_labels=labels,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = BertForSequenceClassification(cfg)
    return save_ckpt(model, d, cfg), model


def llama_dir(d, seed=2, tie=False, layers=2, vocab=89):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    tcfg = LlamaConfig(vocab_size=vocab, hidden_size=48, num_hidden_layers=layers,
                       num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
                       max_position_embeddings=128, rms_norm_eps=1e-5,
                       attention_dropout=0.0, tie_word_embeddings=tie)
    model = LlamaForCausalLM(tcfg)
    return save_ckpt(model, d, tcfg), model


def gpt2_dir(d, seed=7, vocab=93, layers=2):
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(seed)
    tcfg = GPT2Config(vocab_size=vocab, n_embd=48, n_layer=layers, n_head=4, n_positions=64,
                      resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    model = GPT2LMHeadModel(tcfg)
    return save_ckpt(model, d, tcfg), model


def resnet_dir(d, seed=3, labels=4):
    from transformers import ResNetConfig, ResNetForImageClassification

    torch.manual_seed(seed)
    tcfg = ResNetConfig(embedding_size=8, hidden_sizes=[32, 64], depths=[1, 1],
                        layer_type="bottleneck", num_labels=labels)
    model = ResNetForImageClassification(tcfg)
    return save_ckpt(model, d, tcfg), model


def vit_dir(d, seed=1, labels=5):
    from transformers import ViTConfig, ViTForImageClassification

    torch.manual_seed(seed)
    tcfg = ViTConfig(image_size=32, patch_size=8, num_channels=3, hidden_size=48,
                     num_hidden_layers=2, num_attention_heads=3, intermediate_size=96,
                     num_labels=labels, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    model = ViTForImageClassification(tcfg)
    return save_ckpt(model, d, tcfg), model


def mixtral_dir(d):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(5)
    tcfg = MixtralConfig(vocab_size=61, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, num_key_value_heads=2, intermediate_size=32,
                         max_position_embeddings=64, num_local_experts=2,
                         num_experts_per_tok=2, sliding_window=None)
    return save_ckpt(MixtralForCausalLM(tcfg), d, tcfg)


def mixtral4_dir(d, dtype=None):
    """tests/test_convert_hf.py::test_mixtral_parity_sparse_moe's Mixtral: 4
    experts, top-2, GQA 4/2, 2 layers; saved in ``dtype`` (default f32)."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(5)
    tcfg = MixtralConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, intermediate_size=48,
                         max_position_embeddings=64, num_local_experts=4,
                         num_experts_per_tok=2, rms_norm_eps=1e-5, attention_dropout=0.0,
                         sliding_window=None, output_router_logits=False)
    model = MixtralForCausalLM(tcfg)
    if dtype is not None:
        model = model.to(dtype)
    return save_ckpt(model, d, tcfg), model
