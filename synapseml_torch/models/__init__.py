from .text import DeepTextClassifier, DeepTextModel
from .tokenizer import HashingTokenizer, resolve_tokenizer
from .trainer import Trainer, TrainerConfig, TrainState, cross_entropy_loss
from .vision import DeepVisionClassifier, DeepVisionModel

__all__ = ["DeepTextClassifier", "DeepTextModel", "DeepVisionClassifier", "DeepVisionModel",
           "HashingTokenizer", "resolve_tokenizer",
           "Trainer", "TrainerConfig", "TrainState", "cross_entropy_loss"]
