from .text import DeepTextModel
from .tokenizer import HashingTokenizer, resolve_tokenizer

__all__ = ["DeepTextModel", "HashingTokenizer", "resolve_tokenizer"]
