"""Layers of the port's serving slice."""
from .common import Embedding, Linear
from .norm import LayerNorm
from .transformer import MultiHeadAttention

__all__ = ["Embedding", "Linear", "LayerNorm", "MultiHeadAttention"]
