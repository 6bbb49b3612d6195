from .text import DeepTextClassifier, DeepTextModel
from .tokenizer import HashingTokenizer, resolve_tokenizer
from .vision import DeepVisionClassifier, DeepVisionModel

__all__ = ["DeepTextClassifier", "DeepTextModel", "DeepVisionClassifier", "DeepVisionModel",
           "HashingTokenizer", "resolve_tokenizer"]
