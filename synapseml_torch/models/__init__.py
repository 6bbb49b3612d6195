from .text import DeepTextClassifier, DeepTextModel
from .tokenizer import HashingTokenizer, resolve_tokenizer

__all__ = ["DeepTextClassifier", "DeepTextModel", "HashingTokenizer", "resolve_tokenizer"]
