"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).

Each one computes on ``torch.Tensor``; the names exported here take the
Paddle surface's ``Tensor`` too (``core.tensor.tensor_boundary``: its
tensor goes in, and the results come back as ``Tensor`` when an argument
was one). The submodules keep the torch-only functions. ``sigmoid``,
``tanh`` and ``pad`` are the op namespace's (``ops/``), which always
return ``Tensor``; ``relu_``, ``tanh_``, ``softmax_`` and ``elu_`` are the
functional forms under Paddle's in-place names, as in the JAX package.
The fluid-era tail (``extras.py``: ``rnn``, ``birnn``, ``nce``, ...) is
ROADMAP queue A item 2.
"""
from ...core.tensor import tensor_boundary as _boundary
from ...ops.manipulation import pad
from ...ops.math import sigmoid, tanh
from . import activation, attention, common, conv, loss, norm, pooling
from .attention import flash_default_enabled, flash_plan, flash_routable

_TENSOR_FUNCTIONS = (
    (activation, activation.__all__), (common, common.__all__),
    (conv, conv.__all__), (loss, loss.__all__), (norm, norm.__all__),
    (pooling, pooling.__all__),
    (attention, ("flash_core", "scaled_dot_product_attention",
                 "cache_update", "cached_attention")))
for _mod, _names in _TENSOR_FUNCTIONS:
    for _name in _names:
        globals()[_name] = _boundary(getattr(_mod, _name))
del _mod, _names, _name

relu_ = relu  # noqa: F821
tanh_ = tanh
softmax_ = softmax  # noqa: F821
elu_ = elu  # noqa: F821

__all__ = ([n for _, names in _TENSOR_FUNCTIONS for n in names]
           + ["sigmoid", "tanh", "pad", "relu_", "tanh_", "softmax_", "elu_",
              "flash_default_enabled", "flash_plan", "flash_routable"])
