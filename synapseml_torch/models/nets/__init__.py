from .bert import BertClassifier, BertConfig, bert_base, bert_tiny
from .transformer import Attention, Block, Encoder, RMSNorm, TransformerConfig

__all__ = [
    "BertClassifier", "BertConfig", "bert_base", "bert_tiny",
    "Attention", "Block", "Encoder", "RMSNorm", "TransformerConfig",
]
