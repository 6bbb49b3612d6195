from .bert import BertClassifier, BertConfig, bert_base, bert_tiny
from .resnet import BasicBlock, BatchNorm, Bottleneck, ResNet, resnet18, resnet50, resnet_tiny
from .transformer import Attention, Block, Encoder, RMSNorm, TransformerConfig
from .vit import ViTClassifier, vit_b16, vit_tiny

__all__ = [
    "BertClassifier", "BertConfig", "bert_base", "bert_tiny",
    "Attention", "Block", "Encoder", "RMSNorm", "TransformerConfig",
    "ViTClassifier", "vit_b16", "vit_tiny",
    "ResNet", "Bottleneck", "BasicBlock", "BatchNorm", "resnet50", "resnet18", "resnet_tiny",
]
