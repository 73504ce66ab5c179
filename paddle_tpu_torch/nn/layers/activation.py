"""Activation layers (counterparts of
``paddle_tpu/nn/layers/activation.py``): each one calls its functional
with the arguments it was built with, as the JAX package's ``_simple``
layers do; ``Maxout`` and ``PReLU`` are written out. ``PReLU``'s weight
is ``[num_parameters]``, initial value 0.25."""
from __future__ import annotations

import torch

from ..functional import activation as A
from ..initializer import Constant
from ..layer import Layer

__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "ELU", "SELU", "CELU", "Silu", "Swish", "Mish", "Softplus",
    "Softsign", "Hardtanh", "Hardsigmoid", "Hardswish", "Hardshrink",
    "Softshrink", "Tanhshrink", "ThresholdedReLU", "LogSigmoid", "Maxout",
    "PReLU", "GLU",
]


def _simple(name, fn, **defaults):
    """A layer class calling ``fn(x, **kw)``; its constructor takes the
    names of ``defaults``, by position or by keyword (others are
    ignored, as the JAX package ignores them)."""

    def __init__(self, *args, name=None, **kw):
        Layer.__init__(self)
        merged = dict(defaults)
        merged.update(zip(defaults, args))
        merged.update({k: v for k, v in kw.items() if k in merged})
        self._kw = merged

    def forward(self, x):
        return fn(x, **self._kw)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", A.relu)
ReLU6 = _simple("ReLU6", A.relu6)
Sigmoid = _simple("Sigmoid", torch.sigmoid)
Tanh = _simple("Tanh", torch.tanh)
GELU = _simple("GELU", A.gelu, approximate=False)
Softmax = _simple("Softmax", A.softmax, axis=-1)
LogSoftmax = _simple("LogSoftmax", A.log_softmax, axis=-1)
LeakyReLU = _simple("LeakyReLU", A.leaky_relu, negative_slope=0.01)
ELU = _simple("ELU", A.elu, alpha=1.0)
SELU = _simple("SELU", A.selu)
CELU = _simple("CELU", A.celu, alpha=1.0)
Silu = _simple("Silu", A.silu)
Swish = _simple("Swish", A.swish)
Mish = _simple("Mish", A.mish)
Softplus = _simple("Softplus", A.softplus, beta=1.0, threshold=20.0)
Softsign = _simple("Softsign", A.softsign)
Hardtanh = _simple("Hardtanh", A.hardtanh, min=-1.0, max=1.0)
Hardsigmoid = _simple("Hardsigmoid", A.hardsigmoid)
Hardswish = _simple("Hardswish", A.hardswish)
Hardshrink = _simple("Hardshrink", A.hardshrink, threshold=0.5)
Softshrink = _simple("Softshrink", A.softshrink, threshold=0.5)
Tanhshrink = _simple("Tanhshrink", A.tanhshrink)
ThresholdedReLU = _simple("ThresholdedReLU", A.thresholded_relu,
                          threshold=1.0)
LogSigmoid = _simple("LogSigmoid", A.log_sigmoid)
GLU = _simple("GLU", A.glu, axis=-1)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return A.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    """``x`` where positive, else ``weight * x``; ``weight`` is
    ``[num_parameters]`` (1: one slope; C: one per channel of
    ``data_format``), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], weight_attr,
            default_initializer=Constant(init), device=device)

    def forward(self, x):
        return A.prelu(x, self.weight, self._data_format)
