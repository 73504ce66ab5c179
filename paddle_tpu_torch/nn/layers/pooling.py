"""``MaxPool2D`` and ``AdaptiveAvgPool2D`` (counterparts of
``paddle_tpu/nn/layers/pooling.py``)."""
from __future__ import annotations

from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    """Max pooling through ``functional.max_pool2d``."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.return_mask, self.data_format = return_mask, data_format

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.return_mask, self.ceil_mode, self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    """Adaptive average pooling through ``functional.adaptive_avg_pool2d``."""

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, self.data_format)
