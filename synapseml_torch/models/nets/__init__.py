from .bert import BertClassifier, BertConfig, bert_base, bert_tiny
from .llama import LlamaLM, llama2_7b, llama_tiny
from .resnet import BasicBlock, BatchNorm, Bottleneck, ResNet, resnet18, resnet50, resnet_tiny
from .transformer import Attention, Block, Encoder, MoEBlock, RMSNorm, TransformerConfig
from .vit import ViTClassifier, vit_b16, vit_tiny

__all__ = [
    "BertClassifier", "BertConfig", "bert_base", "bert_tiny",
    "LlamaLM", "llama2_7b", "llama_tiny",
    "Attention", "Block", "Encoder", "MoEBlock", "RMSNorm", "TransformerConfig",
    "ViTClassifier", "vit_b16", "vit_tiny",
    "ResNet", "Bottleneck", "BasicBlock", "BatchNorm", "resnet50", "resnet18", "resnet_tiny",
]
