"""Activation functionals of the slice (counterpart of
``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its exact erf form, paddle's default (``jax.nn.gelu`` with
    ``approximate=False`` in the JAX package). On neither AMP list: a
    bfloat16 input gives a bfloat16 output."""
    return torch.nn.functional.gelu(x, approximate="none")
