"""``Conv2D`` (counterpart of ``paddle_tpu/nn/layers/conv.py``).

The weight is ``[out, in / groups, kh, kw]`` in both packages, drawn from
paddle's default for convolutions, Normal(0, sqrt(2 / fan_in)) with
``fan_in = in / groups * kh * kw``, from ``generator`` (the package's
when None); the bias is zeros, or absent with ``bias_attr=False``.
"""
from __future__ import annotations

import math

from ..functional.conv import _pair, conv2d
from ..initializer import Normal
from ..layer import Layer

__all__ = ["Conv2D"]


class Conv2D(Layer):
    """2-D convolution of NCHW activations through ``functional.conv2d``
    (the AMP cast site of the white-listed name ``conv2d``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise NotImplementedError("padding_mode other than zeros")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            weight_attr, default_initializer=Normal(
                0.0, math.sqrt(2.0 / fan_in)), **kw)
        self.bias = self.create_parameter([out_channels], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
