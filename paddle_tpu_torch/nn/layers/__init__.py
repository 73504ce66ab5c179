"""Layers of the port's serving and training slices."""
from .common import Embedding, Linear
from .container import LayerList
from .norm import LayerNorm
from .transformer import MultiHeadAttention

__all__ = ["Embedding", "Linear", "LayerList", "LayerNorm",
           "MultiHeadAttention"]
