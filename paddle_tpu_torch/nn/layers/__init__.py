"""Layers of the port's serving and training slices and of bench.py's
LeNet, ResNet and BERT programs."""
from .activation import ReLU
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .transformer import MultiHeadAttention, TransformerEncoderLayer

__all__ = ["ReLU", "Dropout", "Embedding", "Flatten", "Linear",
           "LayerList", "Sequential", "Conv2D", "BatchNorm2D", "LayerNorm",
           "AdaptiveAvgPool2D", "MaxPool2D", "MultiHeadAttention",
           "TransformerEncoderLayer"]
