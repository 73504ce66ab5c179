"""``Sequential`` and ``LayerList`` (counterparts of
``paddle_tpu/nn/layers/container.py``), over ``torch.nn.Sequential`` and
``torch.nn.ModuleList``: sublayers named ``"0"``, ``"1"``, ... (or by the
names given), so parameter names match the JAX package's."""
from __future__ import annotations

import collections

from torch import nn

__all__ = ["Sequential", "LayerList"]


class Sequential(nn.Sequential):
    """``Sequential(*layers)``, ``Sequential(OrderedDict)`` or
    ``Sequential(("name", layer), ...)``: calls the layers in order."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        named = collections.OrderedDict(
            (l[0], l[1]) if isinstance(l, (tuple, list)) and len(l) == 2
            and isinstance(l[0], str) else (str(i), l)
            for i, l in enumerate(layers))
        super().__init__(named)


class LayerList(nn.ModuleList):
    """``LayerList(sublayers)``: indexable, iterable, ``append``able."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
