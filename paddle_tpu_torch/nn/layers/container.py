"""``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``
(counterparts of ``paddle_tpu/nn/layers/container.py``): ``Layer``s over
``torch.nn.Sequential``, ``ModuleList``, ``ParameterList`` and
``ModuleDict``, entries named ``"0"``, ``"1"``, ... (or by the names or
keys given), so state-dict names match the JAX package's."""
from __future__ import annotations

import collections

from torch import nn

from ..layer import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


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


class ParameterList(Layer, nn.ParameterList):
    """``ParameterList(parameters)``: indexable, iterable, ``append``able;
    the parameters are named ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.extend(parameters)


class LayerDict(Layer, nn.ModuleDict):
    """``LayerDict(sublayers)`` (a dict or ``(key, layer)`` pairs):
    sublayers by key, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)
