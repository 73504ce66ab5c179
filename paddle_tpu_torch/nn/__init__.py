"""``nn`` of the port: ``Layer`` and ``ParamAttr``, the initializers, and
the functionals, layers and gradient clips the serving and training
slices and bench.py's training programs run."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer, ParamAttr
from .layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                     Embedding, Flatten, LayerList, LayerNorm, Linear,
                     MaxPool2D, MultiHeadAttention, ReLU, Sequential,
                     TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "Layer", "ParamAttr",
           "AdaptiveAvgPool2D", "BatchNorm2D",
           "Conv2D", "Dropout", "Embedding", "Flatten", "LayerList",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "ReLU",
           "Sequential", "TransformerEncoderLayer", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
