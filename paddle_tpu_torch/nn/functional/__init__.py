"""Functionals of the port's serving slice."""
from .activation import gelu
from .attention import (
    cache_update, cached_attention, flash_core, flash_plan,
    scaled_dot_product_attention,
)
from .norm import fused_residual_layer_norm, layer_norm

__all__ = [
    "gelu", "layer_norm", "fused_residual_layer_norm", "flash_plan",
    "flash_core", "scaled_dot_product_attention", "cache_update",
    "cached_attention",
]
