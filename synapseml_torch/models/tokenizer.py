"""Tokenizers for the text stages.

Counterpart of ``synapseml_tpu/models/tokenizer.py``: the self-contained
hashing tokenizer gives the same ids and masks for the same text. The
HuggingFace adapter comes in a later slice; until then a HuggingFace
tokenizer spec is refused with a clear error.
"""

from __future__ import annotations

import re
import zlib
from typing import Sequence

import numpy as np

from ..parallel.batching import pad_sequences

__all__ = ["HashingTokenizer", "resolve_tokenizer"]

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.IGNORECASE)


class HashingTokenizer:
    """Deterministic feature-hashing tokenizer: token -> 2 + crc32(token) % (V-2).
    ids 0/1 reserved for [PAD]/[CLS]."""

    PAD, CLS = 0, 1

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True, add_cls: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.add_cls = add_cls

    def tokenize(self, text: str) -> list[int]:
        if self.lowercase:
            text = text.lower()
        toks = _WORD_RE.findall(text or "")
        ids = [2 + (zlib.crc32(t.encode()) % (self.vocab_size - 2)) for t in toks]
        return ([self.CLS] + ids) if self.add_cls else ids

    def __call__(self, texts: Sequence[str], max_len: int = 128,
                 multiple_of: int = 8) -> dict[str, np.ndarray]:
        seqs = [self.tokenize(t) for t in texts]
        ids, mask = pad_sequences(seqs, max_len=max_len, pad_value=self.PAD,
                                  multiple_of=multiple_of)
        return {"input_ids": ids, "attention_mask": mask}

    def to_config(self) -> dict:
        return {"kind": "hashing", "vocab_size": self.vocab_size,
                "lowercase": self.lowercase, "add_cls": self.add_cls}

    @staticmethod
    def from_config(cfg: dict) -> "HashingTokenizer":
        return HashingTokenizer(cfg["vocab_size"], cfg["lowercase"], cfg["add_cls"])


def resolve_tokenizer(spec) -> HashingTokenizer:
    """spec: None | HashingTokenizer | config dict."""
    if spec is None:
        return HashingTokenizer()
    if isinstance(spec, HashingTokenizer):
        return spec
    if isinstance(spec, dict) and spec.get("kind", "hashing") == "hashing":
        return HashingTokenizer.from_config(spec)
    if isinstance(spec, (dict, str)):
        raise ValueError(f"tokenizer {spec!r}: only the hashing tokenizer is "
                         "available in this package so far; pass None or a "
                         "HashingTokenizer config")
    raise TypeError(f"cannot build tokenizer from {spec!r}")
