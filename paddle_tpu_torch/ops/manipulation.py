"""Shape manipulation (the part of ``paddle_tpu/ops/manipulation.py`` that
the ported models use): ``flatten``."""
from __future__ import annotations

import torch

__all__ = ["flatten"]


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge the axes ``start_axis..stop_axis`` (inclusive) into one."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)
