"""``nn`` of the port: the functionals, layers and gradient clips the
serving and training slices and bench.py's training programs run."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                     Embedding, Flatten, LayerList, LayerNorm, Linear,
                     MaxPool2D, MultiHeadAttention, ReLU, Sequential,
                     TransformerEncoderLayer)

__all__ = ["clip", "functional", "AdaptiveAvgPool2D", "BatchNorm2D",
           "Conv2D", "Dropout", "Embedding", "Flatten", "LayerList",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "ReLU",
           "Sequential", "TransformerEncoderLayer", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
