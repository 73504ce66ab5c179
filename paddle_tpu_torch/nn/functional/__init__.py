"""Functionals of the port's serving and training slices."""
from .activation import gelu
from .attention import (
    cache_update, cached_attention, flash_core, flash_plan,
    scaled_dot_product_attention,
)
from .common import dropout, linear
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import fused_residual_layer_norm, layer_norm

__all__ = [
    "gelu", "linear", "dropout", "layer_norm", "fused_residual_layer_norm",
    "flash_plan", "flash_core", "scaled_dot_product_attention",
    "cache_update", "cached_attention", "cross_entropy",
    "fused_linear_cross_entropy",
]
