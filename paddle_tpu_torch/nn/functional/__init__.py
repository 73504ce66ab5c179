"""Functionals of the port's serving and training slices."""
from .activation import gelu, relu
from .attention import (
    cache_update, cached_attention, flash_core, flash_plan,
    scaled_dot_product_attention,
)
from .common import dropout, linear
from .conv import conv2d
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import batch_norm, fused_residual_layer_norm, layer_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = [
    "gelu", "relu", "linear", "dropout", "conv2d", "max_pool2d",
    "adaptive_avg_pool2d", "batch_norm", "layer_norm",
    "fused_residual_layer_norm",
    "flash_plan", "flash_core", "scaled_dot_product_attention",
    "cache_update", "cached_attention", "cross_entropy",
    "fused_linear_cross_entropy",
]
