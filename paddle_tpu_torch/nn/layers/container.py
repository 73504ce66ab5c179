"""``Sequential`` and ``LayerList`` (counterparts of
``paddle_tpu/nn/layers/container.py``): ``Layer``s over
``torch.nn.Sequential`` and ``torch.nn.ModuleList``, sublayers named
``"0"``, ``"1"``, ... (or by the names given), so parameter names match
the JAX package's."""
from __future__ import annotations

import collections

from torch import nn

from ..layer import Layer

__all__ = ["Sequential", "LayerList"]


class Sequential(Layer, nn.Sequential):
    """``Sequential(*layers)``, ``Sequential(OrderedDict)`` or
    ``Sequential(("name", layer), ...)``: calls the layers in order."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            named = layers[0]
        else:
            named = collections.OrderedDict(
                (l[0], l[1]) if isinstance(l, (tuple, list)) and len(l) == 2
                and isinstance(l[0], str) else (str(i), l)
                for i, l in enumerate(layers))
        for name, layer in named.items():
            self.add_module(name, layer)


class LayerList(Layer, nn.ModuleList):
    """``LayerList(sublayers)``: indexable, iterable, ``append``able."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)
