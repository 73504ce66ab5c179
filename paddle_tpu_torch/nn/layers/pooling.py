"""Pooling layers (counterparts of ``paddle_tpu/nn/layers/pooling.py``):
each holds its functional's options and calls it. The max-pool layers
pass ``return_mask`` on (the functionals' named departure); the average
layers take ``divisor_override`` and do not use it, as the JAX package's
do; the adaptive layers take ``data_format`` and pool channels-first
whatever it says, as the JAX package's do, and
``AdaptiveMaxPool*D(return_mask=True)`` returns the mask."""
from __future__ import annotations

from ..functional import pooling as P
from ..layer import Layer

__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]


class _MaxPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, exclusive=True, divisor_override=None,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.return_mask, self.data_format = return_mask, data_format

    def forward(self, x):
        kw = {} if self.data_format is None \
            else {"data_format": self.data_format}
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              self.return_mask, self.ceil_mode, **kw)


class MaxPool1D(_MaxPool):
    _fn = staticmethod(P.max_pool1d)


class MaxPool2D(_MaxPool):
    _fn = staticmethod(P.max_pool2d)


class MaxPool3D(_MaxPool):
    _fn = staticmethod(P.max_pool3d)


class _AvgPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, divisor_override=None, data_format=None,
                 name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.exclusive = padding, exclusive
        self.ceil_mode, self.data_format = ceil_mode, data_format

    def forward(self, x):
        kw = {} if self.data_format is None \
            else {"data_format": self.data_format}
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              exclusive=self.exclusive,
                              ceil_mode=self.ceil_mode, **kw)


class AvgPool1D(_AvgPool):
    _fn = staticmethod(P.avg_pool1d)


class AvgPool2D(_AvgPool):
    _fn = staticmethod(P.avg_pool2d)


class AvgPool3D(_AvgPool):
    _fn = staticmethod(P.avg_pool3d)


class _AdaptivePool(Layer):
    _n, _kind = 2, "avg"

    def __init__(self, output_size, data_format=None, return_mask=False,
                 name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return P._adaptive(x, self.output_size, self._n, self._kind,
                           return_mask=self.return_mask
                           and self._kind == "max")


class _AdaptiveAvg(_AdaptivePool):
    pass


class _AdaptiveMax(_AdaptivePool):
    _kind = "max"


class AdaptiveAvgPool1D(_AdaptiveAvg):
    _n = 1


class AdaptiveAvgPool2D(_AdaptiveAvg):
    """Adaptive average pooling through ``functional.adaptive_avg_pool2d``."""


class AdaptiveAvgPool3D(_AdaptiveAvg):
    _n = 3


class AdaptiveMaxPool1D(_AdaptiveMax):
    _n = 1


class AdaptiveMaxPool2D(_AdaptiveMax):
    pass


class AdaptiveMaxPool3D(_AdaptiveMax):
    _n = 3
