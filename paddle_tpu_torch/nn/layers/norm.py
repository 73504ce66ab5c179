"""``LayerNorm`` and ``BatchNorm2D`` (counterparts of
``paddle_tpu/nn/layers/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm", "BatchNorm2D"]


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight ones,
    bias zeros, epsilon 1e-5 as paddle's. Routes through
    ``functional.layer_norm`` (the B5 kernel when eligible)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class BatchNorm2D(nn.Module):
    """Batch norm over the channels of NCHW activations through
    ``functional.batch_norm``: weight ones, bias zeros, and the running
    statistics in the buffers ``_mean`` (zeros) and ``_variance`` (ones),
    float32, updated by the forward in training (momentum 0.9)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device,
                 dtype=torch.float32):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None, False):
            raise NotImplementedError(
                "BatchNorm2D: ParamAttr is not ported yet")
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw))
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
