"""``LayerList`` (counterpart of paddle's ``nn.LayerList``): a list of
sublayers whose parameters the model owns, over ``torch.nn.ModuleList``."""
from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    """``LayerList(sublayers)``: indexable, iterable, ``append``able."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
