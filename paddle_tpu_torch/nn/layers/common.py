"""``Embedding``, ``Linear``, ``Dropout`` and ``Flatten`` (counterparts of
``paddle_tpu/nn/layers/common.py``).

Weights follow PyTorch's layout: ``Linear.weight`` is ``[out, in]``, where
paddle stores ``[in, out]`` (``weights.from_paddle_tpu_state`` transposes
on the way in). Initialization is paddle's: XavierNormal weights, zero
bias, drawn from the caller's generator.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.random import xavier_normal
from ...ops.manipulation import flatten
from ..functional.common import dropout, linear

__all__ = ["Embedding", "Linear", "Dropout", "Flatten"]


class Linear(nn.Module):
    """y = x W^T + b with W ``[out_features, in_features]``, through
    ``functional.linear`` (the AMP cast site)."""

    def __init__(self, in_features, out_features, *, device,
                 dtype=torch.float32, generator):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(xavier_normal(
            (out_features, in_features), in_features, out_features,
            generator=generator, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup in a ``[num_embeddings, embedding_dim]`` table."""

    def __init__(self, num_embeddings, embedding_dim, *, device,
                 dtype=torch.float32, generator):
        super().__init__()
        self.weight = nn.Parameter(xavier_normal(
            (num_embeddings, embedding_dim), num_embeddings, embedding_dim,
            generator=generator, device=device, dtype=dtype))

    def forward(self, ids):
        return nn.functional.embedding(ids.to(torch.int64), self.weight)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    """``functional.dropout`` in training, the identity (or the
    ``downscale_in_infer`` scaling) in eval; the mask comes from
    ``generator``, which a layer with ``0 < p < 1`` must be given to
    train."""

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


class Flatten(nn.Module):
    """Merge the axes ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)
