"""Norm layers (counterparts of ``paddle_tpu/nn/layers/norm.py``):
``LayerNorm``, the batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``,
``SyncBatchNorm``), ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``.

``SyncBatchNorm`` on one device is ``BatchNorm`` (the JAX package's
reasoning: inside one program the batch axis is already global);
``convert_sync_batchnorm`` turns a model's batch norms into it. More than
one device is ROADMAP queue A item 7. ``SpectralNorm`` raises
``NotImplementedError`` on construction, as the JAX package's does.
"""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from .. import functional as F
from ..functional import activation as A
from ..functional import norm as N
from ..initializer import Constant
from ..layer import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]


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


def _affine_params(layer, num_features, weight_attr, bias_attr, device):
    layer.weight = layer.create_parameter(
        [num_features], weight_attr, default_initializer=Constant(1.0),
        device=device)
    layer.bias = layer.create_parameter([num_features], bias_attr,
                                        is_bias=True, device=device)


class _BatchNormBase(Layer):
    """Batch norm over the channels (axis 1 for ``NC...``, the last
    otherwise) through ``functional.batch_norm``: weight ones, bias zeros
    (``False`` as an attr: none), and the running statistics in the
    buffers ``_mean`` (zeros) and ``_variance`` (ones), updated by the
    forward in training as ``running * momentum + batch * (1 -
    momentum)``."""

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
        _affine_params(self, num_features, weight_attr, bias_attr, dev)
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


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


def _activation(name):
    """A functional by name, Paddle's defaults (``sigmoid`` and ``tanh``
    are torch's)."""
    return getattr(A, name, None) or getattr(torch, name)


class BatchNorm(_BatchNormBase):
    """The fluid-style ``BatchNorm(num_channels, act=...)``: the same batch
    norm, then the activation ``act`` by name."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 trainable_statistics=False, *, device=None, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return _activation(self._act)(out) if self._act else out


class SyncBatchNorm(_BatchNormBase):
    """Batch norm across replicas; on one device, ``BatchNorm2D``."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every batch norm of ``layer`` (itself included) becomes a
        ``SyncBatchNorm`` in place; returns ``layer``."""
        for sub in layer.sublayers(include_self=True):
            if isinstance(sub, _BatchNormBase):
                sub.__class__ = SyncBatchNorm
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        _affine_params(self, num_channels, weight_attr, bias_attr, device)

    def forward(self, x):
        return N.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._epsilon, self._data_format = epsilon, data_format
        _affine_params(self, num_features, weight_attr, bias_attr, device)

    def forward(self, x):
        return N.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return N.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        raise NotImplementedError(
            "SpectralNorm is not implemented in the JAX package either")
