"""``Embedding`` and ``Linear`` (counterparts of
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
from ..functional.common import linear

__all__ = ["Embedding", "Linear"]


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
