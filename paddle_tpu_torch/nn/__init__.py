"""``nn`` of the port: the functionals, layers and gradient clips the
serving and training slices run."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import Embedding, LayerList, LayerNorm, Linear, \
    MultiHeadAttention

__all__ = ["clip", "functional", "Embedding", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
