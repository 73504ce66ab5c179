"""``ReLU`` (counterpart of ``paddle_tpu/nn/layers/activation.py``)."""
from __future__ import annotations

from torch import nn

from ..functional.activation import relu

__all__ = ["ReLU"]


class ReLU(nn.Module):
    """max(x, 0), through ``functional.relu``."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
