"""Functionals of the port's serving and training slices.

Each one computes on ``torch.Tensor``; the names exported here take the
Paddle surface's ``Tensor`` too (``core.tensor.tensor_boundary``: its
tensor goes in, and the results come back as ``Tensor`` when an argument
was one). The submodules keep the torch-only functions.
"""
from ...core.tensor import tensor_boundary as _boundary
from . import activation, attention, common, conv, loss, norm, pooling
from .attention import flash_plan

gelu = _boundary(activation.gelu)
relu = _boundary(activation.relu)
linear = _boundary(common.linear)
dropout = _boundary(common.dropout)
conv2d = _boundary(conv.conv2d)
max_pool2d = _boundary(pooling.max_pool2d)
adaptive_avg_pool2d = _boundary(pooling.adaptive_avg_pool2d)
batch_norm = _boundary(norm.batch_norm)
layer_norm = _boundary(norm.layer_norm)
fused_residual_layer_norm = _boundary(norm.fused_residual_layer_norm)
flash_core = _boundary(attention.flash_core)
scaled_dot_product_attention = _boundary(
    attention.scaled_dot_product_attention)
cache_update = _boundary(attention.cache_update)
cached_attention = _boundary(attention.cached_attention)
cross_entropy = _boundary(loss.cross_entropy)
fused_linear_cross_entropy = _boundary(loss.fused_linear_cross_entropy)

__all__ = [
    "gelu", "relu", "linear", "dropout", "conv2d", "max_pool2d",
    "adaptive_avg_pool2d", "batch_norm", "layer_norm",
    "fused_residual_layer_norm",
    "flash_plan", "flash_core", "scaled_dot_product_attention",
    "cache_update", "cached_attention", "cross_entropy",
    "fused_linear_cross_entropy",
]
