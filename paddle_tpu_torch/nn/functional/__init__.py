"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``).

Each one computes on ``torch.Tensor``; the names exported here take the
Paddle surface's ``Tensor`` too (``core.tensor.tensor_boundary``: its
tensor goes in, and the results come back as ``Tensor`` when an argument
was one). The submodules keep the torch-only functions. ``sigmoid``,
``tanh`` and ``pad`` are the op namespace's (``ops/``), which always
return ``Tensor``; ``relu_``, ``tanh_``, ``softmax_`` and ``elu_`` are the
functional forms under Paddle's in-place names, as in the JAX package.
The LoD sequence ops of ``ops/sequence.py`` are re-exported here, as the
JAX package does. The fluid-era tail (``extras.py``: ``rnn``, ``birnn``, ``nce``, ...) is
exported the same way, but for its tensor-array names, which take and
give Python lists as they are.
"""
from ...core.tensor import tensor_boundary as _boundary
from ...ops.manipulation import pad
from ...ops.math import sigmoid, tanh
from ...ops.sequence import (  # noqa: F401  (the reference re-exports)
    sequence_concat, sequence_conv, sequence_enumerate, sequence_erase,
    sequence_expand, sequence_expand_as, sequence_first_step,
    sequence_last_step, sequence_mask, sequence_pad, sequence_pool,
    sequence_reshape, sequence_reverse, sequence_scatter, sequence_slice,
    sequence_softmax, sequence_unpad)
from . import (activation, attention, common, conv, extras, loss, norm,
               pooling)
from .attention import flash_default_enabled, flash_plan, flash_routable

_TENSOR_FUNCTIONS = (
    (activation, activation.__all__), (common, common.__all__),
    (conv, conv.__all__), (loss, loss.__all__), (norm, norm.__all__),
    (pooling, pooling.__all__),
    (extras, [n for n in extras.__all__ if n not in extras.ARRAY_FUNCTIONS]),
    (attention, ("flash_core", "scaled_dot_product_attention",
                 "cache_update", "cached_attention")))
for _mod, _names in _TENSOR_FUNCTIONS:
    for _name in _names:
        globals()[_name] = _boundary(getattr(_mod, _name))
del _mod, _names, _name
for _name in extras.ARRAY_FUNCTIONS:
    globals()[_name] = getattr(extras, _name)
del _name

relu_ = relu  # noqa: F821
tanh_ = tanh
softmax_ = softmax  # noqa: F821
elu_ = elu  # noqa: F821

__all__ = ([n for _, names in _TENSOR_FUNCTIONS for n in names]
           + list(extras.ARRAY_FUNCTIONS)
           + ["sigmoid", "tanh", "pad", "relu_", "tanh_", "softmax_", "elu_",
              "flash_default_enabled", "flash_plan", "flash_routable"])
