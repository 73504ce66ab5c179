"""``LayerNorm`` and ``BatchNorm2D`` (counterparts of
``paddle_tpu/nn/layers/norm.py``)."""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import Constant
from ..layer import Layer

__all__ = ["LayerNorm", "BatchNorm2D"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight ones,
    bias zeros (or none, with ``False`` as the attr), epsilon 1e-5 as
    paddle's. Routes through ``functional.layer_norm`` (the B5 kernel
    when eligible)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = self.create_parameter(
            self.normalized_shape, weight_attr,
            default_initializer=Constant(1.0), device=device)
        self.bias = self.create_parameter(self.normalized_shape, bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class BatchNorm2D(Layer):
    """Batch norm over the channels of NCHW activations through
    ``functional.batch_norm``: weight ones, bias zeros (``False`` as an
    attr: none), and the running statistics in the buffers ``_mean``
    (zeros) and ``_variance`` (ones), updated by the forward in training
    (momentum 0.9)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.weight = self.create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0),
            device=dev)
        self.bias = self.create_parameter([num_features], bias_attr,
                                          is_bias=True, device=dev)
        kw = dict(device=dev, dtype=self._dtype)
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")
