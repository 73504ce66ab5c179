"""``nn`` of the port: the functionals and layers the serving slice runs."""
from . import functional
from .layers import Embedding, LayerNorm, Linear, MultiHeadAttention

__all__ = ["functional", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention"]
