"""BERT-style text encoder + classification head.

Counterpart of ``synapseml_tpu/models/flax_nets/bert.py``: the same presets
(``bert_base``: hidden 768, 12 layers, 12 heads, MLP 3072; ``bert_tiny``),
post-norm blocks with LayerNorm eps 1e-12, word + position + segment
embeddings summed in the compute dtype, CLS pooling, a tanh pooler and an
f32 classifier.
"""

from __future__ import annotations

import torch
from torch import nn

from .transformer import Encoder, LayerNorm, TransformerConfig, dense

__all__ = ["BertConfig", "BertEmbeddings", "BertClassifier", "bert_base", "bert_tiny"]


def BertConfig(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=30522, hidden=768, n_layers=12, n_heads=12,
                    mlp_dim=3072, max_len=512, norm="layernorm", act="gelu",
                    norm_position="post", norm_eps=1e-12)
    defaults.update(kw)
    return TransformerConfig(**defaults)


def bert_base(**kw) -> TransformerConfig:
    return BertConfig(**kw)


def bert_tiny(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=1024, hidden=64, n_layers=2, n_heads=2, mlp_dim=128, max_len=128)
    defaults.update(kw)
    return BertConfig(**defaults)


def _embedding(num: int, dim: int, dtype: torch.dtype) -> nn.Embedding:
    """``nn.Embedding`` that skips its init on the meta device: there its
    ``normal_`` runs through ``torch._refs`` and so imports ``torch._dynamo``,
    which a module built only to receive a state_dict does not need."""
    weight = torch.empty(num, dim, dtype=dtype)
    emb = nn.Embedding(num, dim, _weight=weight)
    if not weight.is_meta:
        emb.reset_parameters()
    return emb


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: TransformerConfig, n_segments: int = 2):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.word = _embedding(cfg.vocab_size, cfg.hidden, pd)
        self.position = _embedding(cfg.max_len, cfg.hidden, pd)
        self.segment = _embedding(n_segments, cfg.hidden, pd)
        self.norm = LayerNorm(cfg.hidden, cfg.norm_eps, cfg.dtype, pd)

    def forward(self, input_ids, token_type_ids=None):
        dt = self.cfg.dtype
        x = self.word(input_ids).to(dt)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = x + self.position(pos).to(dt)
        if token_type_ids is None:
            # every token in segment 0: row 0 broadcast, whose gradient is
            # a reduction in a fixed order (the embedding backward of one id
            # repeated over every token summed in an order that differed
            # between two runs on the card)
            seg = self.segment.weight[0].expand(*input_ids.shape, -1)
        else:
            seg = self.segment(token_type_ids)
        return self.norm(x + seg.to(dt))


class BertClassifier(nn.Module):
    """[B,T] token ids -> [B,num_classes] f32 logits (CLS pooling)."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = Encoder(cfg)
        self.pooler = nn.Linear(cfg.hidden, cfg.hidden, dtype=pd)
        self.classifier = nn.Linear(cfg.hidden, num_classes, dtype=pd)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()  # [B,1,1,T]
        x = self.encoder(x, mask)
        pooled = torch.tanh(dense(self.pooler, x[:, 0], self.cfg.dtype))
        return dense(self.classifier, pooled, torch.float32)
