"""Tokenizers for the text stages.

Counterpart of ``synapseml_tpu/models/tokenizer.py``: the self-contained
hashing tokenizer gives the same ids and masks for the same text, and a
``transformers`` tokenizer plugs in through :func:`from_huggingface` (a
local checkpoint directory or a name in the local HuggingFace cache).

``transformers`` is imported only inside :func:`from_huggingface`, and is
asked for local files only: this package never downloads. On a host
without it, a HuggingFace name ends in the same ``ValueError`` as a name
that cannot be loaded.
"""

from __future__ import annotations

import re
import zlib
from typing import Sequence

import numpy as np

from ..core.batching import round_up_to_multiple
from ..parallel.batching import pad_sequences

__all__ = ["HashingTokenizer", "from_huggingface", "resolve_tokenizer"]

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


class _HFTokenizerAdapter:
    def __init__(self, tok, name: str):
        self._tok = tok
        self.name = name
        self.vocab_size = tok.vocab_size

    def __call__(self, texts, max_len: int = 128, multiple_of: int = 8):
        L = round_up_to_multiple(max_len, multiple_of)
        enc = self._tok(list(texts), padding="max_length", truncation=True, max_length=L,
                        return_tensors="np")
        return {"input_ids": enc["input_ids"].astype(np.int32),
                "attention_mask": enc["attention_mask"].astype(np.int32)}

    def decode(self, token_ids) -> str:
        """Detokenize (the HF tokenizer can; the hashing one cannot): the
        causal-LM transform probes for this."""
        return self._tok.decode(list(token_ids), skip_special_tokens=True)

    def to_config(self) -> dict:
        return {"kind": "huggingface", "name": self.name}


def from_huggingface(name: str) -> _HFTokenizerAdapter:
    """``AutoTokenizer.from_pretrained(name)`` from local files only."""
    from transformers import AutoTokenizer

    return _HFTokenizerAdapter(AutoTokenizer.from_pretrained(name, local_files_only=True), name)


def resolve_tokenizer(spec) -> HashingTokenizer | _HFTokenizerAdapter:
    """spec: None | tokenizer obj | config dict | HF checkpoint dir or name."""
    if spec is None:
        return HashingTokenizer()
    if isinstance(spec, (HashingTokenizer, _HFTokenizerAdapter)):
        return spec
    if isinstance(spec, dict):
        if spec.get("kind") == "huggingface":
            return from_huggingface(spec["name"])
        return HashingTokenizer.from_config(spec)
    if isinstance(spec, str):
        try:
            return from_huggingface(spec)
        except Exception as e:
            raise ValueError(
                f"could not load HuggingFace tokenizer {spec!r} ({e}); pass "
                "tokenizer=None for the self-contained HashingTokenizer") from e
    raise TypeError(f"cannot build tokenizer from {spec!r}")
