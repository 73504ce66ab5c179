"""``Embedding``, ``Linear``, ``Dropout`` and ``Flatten`` (counterparts of
``paddle_tpu/nn/layers/common.py``), with its arguments in its order.

Weights are paddle's layout: ``Linear.weight`` is ``[in, out]``, as in
the JAX package, so its ``state_dict()`` loads with no transposes. The
initializers are paddle's: XavierNormal weights, zero bias, drawn from
``generator`` (the package's generator of ``device``, which
``paddle.seed`` seeds, when None). ``device`` is the ``set_device``
default when None, ``dtype`` the default float type.
"""
from __future__ import annotations

import torch

from ..functional.common import dropout, linear
from ..initializer import XavierNormal
from ..layer import Layer

__all__ = ["Embedding", "Linear", "Dropout", "Flatten"]


class Linear(Layer):
    """y = x W + b with W ``[in_features, out_features]``, through
    ``functional.linear`` (the AMP cast site)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = self.create_parameter([out_features], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    """Row lookup in a ``[num_embeddings, embedding_dim]`` table; ids equal
    to ``padding_idx`` (when given) look up zeros and send no gradient."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if sparse:
            raise NotImplementedError("Embedding(sparse=True) is not ported")
        self._padding_idx = None if padding_idx is None \
            else padding_idx % num_embeddings
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=XavierNormal(), device=device,
            generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, ids):
        ids = ids.long()
        out = torch.nn.functional.embedding(ids, self.weight)
        if self._padding_idx is not None:
            out = out.masked_fill((ids == self._padding_idx)[..., None], 0.0)
        return out

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
    """``functional.dropout`` in training, the identity (or the
    ``downscale_in_infer`` scaling) in eval; the mask comes from
    ``generator`` (the package's generator of the input's device when
    None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self._generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


def flatten(x, start_axis=0, stop_axis=-1):
    """Merge the axes ``start_axis..stop_axis`` (inclusive) of a
    ``torch.Tensor`` into one (a 0-d tensor becomes ``[1]``)."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


class Flatten(Layer):
    """Merge the axes ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)
