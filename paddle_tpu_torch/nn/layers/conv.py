"""Convolution layers (counterparts of ``paddle_tpu/nn/layers/conv.py``):
``Conv1D/2D/3D`` and ``Conv1DTranspose/2DTranspose/3DTranspose`` on the
JAX package's ``_ConvNd`` parameters.

The weight is ``[out, in / groups, k...]`` (``[in, out / groups, k...]``
for a transposed one) in both packages, drawn from paddle's default for
convolutions, Normal(0, sqrt(2 / fan_in)) with ``fan_in = in / groups *
prod(k)``, from ``generator`` (the package's when None); the bias is
zeros, or absent with ``bias_attr=False``.

``padding_mode`` "reflect", "replicate" or "circular" pads the input
that way by the layer's padding, then convolves with none: upstream
Paddle's function. The JAX package refuses any mode but "zeros"; this is
a named departure.
"""
from __future__ import annotations

import math

import torch

from ...ops.manipulation import pad
from ..functional import conv as C
from ..initializer import Normal
from ..layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_PADDING_MODES = ("zeros", "reflect", "replicate", "circular")


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, n, transpose=False,
                 output_padding=0, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode not in _PADDING_MODES:
            raise ValueError(f"padding_mode must be one of {_PADDING_MODES}")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = C._ntuple(kernel_size, n)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode = padding_mode
        self._data_format, self._n = data_format, n
        self._output_padding = output_padding
        shape = [in_channels, out_channels // groups] if transpose \
            else [out_channels, in_channels // groups]
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape + list(self._kernel_size), weight_attr,
            default_initializer=Normal(0.0, math.sqrt(2.0 / fan_in)), **kw)
        self.bias = self.create_parameter([out_channels], bias_attr,
                                          is_bias=True, **kw)

    def _conv(self, x):
        padding = self._padding
        if self._padding_mode != "zeros":
            last = not self._data_format.startswith("NC")
            xc = torch.movedim(x, -1, 1) if last else x
            pads = C._pads(padding, xc, self.weight,
                           C._ntuple(self._stride, self._n),
                           C._ntuple(self._dilation, self._n))
            flat = [v for pair in reversed(pads) for v in pair]
            x = pad(x, flat, self._padding_mode,
                    data_format=self._data_format)._data
            padding = 0
        conv = getattr(C, f"conv{self._n}d")
        return conv(x, self.weight, self.bias, self._stride, padding,
                    self._dilation, self._groups, self._data_format)

    def _conv_transpose(self, x, output_size):
        conv = getattr(C, f"conv{self._n}d_transpose")
        return conv(x, self.weight, self.bias, self._stride, self._padding,
                    self._output_padding, self._groups, self._dilation,
                    output_size, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self._conv(x)


class Conv2D(_ConvNd):
    """2-D convolution through ``functional.conv2d`` (the AMP cast site of
    the white-listed name ``conv2d``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self._conv(x)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        return self._conv(x)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, True, output_padding,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x, output_size=None):
        return self._conv_transpose(x, output_size)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, True, output_padding,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x, output_size=None):
        return self._conv_transpose(x, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, True, output_padding,
                         device=device, dtype=dtype, generator=generator)

    def forward(self, x, output_size=None):
        return self._conv_transpose(x, output_size)
