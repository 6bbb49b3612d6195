"""Vision Transformer: the backbone of DeepVisionClassifier.

Counterpart of ``synapseml_tpu/models/flax_nets/vit.py`` (``:18-62``), on
this package's pre-norm :class:`.transformer.Encoder`, with the same
numerics:

  * the patch embedding is Flax's ``nn.Conv`` with its default ``'SAME'``
    padding: when H or W is not a multiple of the patch, the image is
    padded with ``total // 2`` zero rows (columns) before it and the rest
    after, where ``total = (ceil(H / p) - 1) * p + p - H`` (``F.conv2d``'s
    symmetric ``padding=`` is not that);
  * weights in ``cfg.param_dtype``, the embedding, encoder and sum with the
    position table in ``cfg.dtype``; the head is a float32 dense layer on
    the ``cls`` token, so logits come back in float32.

``forward(x)`` takes ``[B, H, W, C]`` images as the keyword ``x``, as the
trainer passes a batch's ``x`` column.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import Encoder, TransformerConfig, dense

__all__ = ["vit_b16", "vit_tiny", "ViTClassifier", "same_padding"]


def vit_b16(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=1, hidden=768, n_layers=12, n_heads=12, mlp_dim=3072,
                    max_len=1 + (224 // 16) ** 2, norm="layernorm", act="gelu")
    defaults.update(kw)
    return TransformerConfig(**defaults)


def vit_tiny(**kw) -> TransformerConfig:
    defaults = dict(vocab_size=1, hidden=64, n_layers=2, n_heads=2, mlp_dim=128,
                    max_len=1 + (32 // 8) ** 2)
    defaults.update(kw)
    return TransformerConfig(**defaults)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) zero padding of one spatial dim under XLA's 'SAME'."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ViTClassifier(nn.Module):
    """[B, H, W, C] images -> [B, num_classes] float32 logits."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 1000, patch: int = 16,
                 in_channels: int = 3):
        super().__init__()
        self.cfg, self.patch = cfg, patch
        pd = cfg.param_dtype
        self.patch_embed = nn.Conv2d(in_channels, cfg.hidden, patch, stride=patch, dtype=pd)
        self.cls = nn.Parameter(torch.zeros(1, 1, cfg.hidden, dtype=pd))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_len, cfg.hidden, dtype=pd))
        self.encoder = Encoder(cfg)
        self.head = nn.Linear(cfg.hidden, num_classes, dtype=pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self.patch
        dt = cfg.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        top, bottom = same_padding(x.shape[2], p, p)
        left, right = same_padding(x.shape[3], p, p)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, self.patch_embed.weight.to(dt), self.patch_embed.bias.to(dt), stride=p)
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, hidden], rows in (h, w) order
        cls = self.cls.expand(B, 1, cfg.hidden).to(dt)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]].to(dt)
        x = self.encoder(x)
        return dense(self.head, x[:, 0], torch.float32)
