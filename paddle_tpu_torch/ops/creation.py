"""Tensor creation (the part of ``paddle_tpu/ops/creation.py`` that the
ported models use): ``arange``."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.device import resolve_device

__all__ = ["arange"]

_DTYPES = {"int32": torch.int32, "int64": torch.int64,
           "float32": torch.float32, "float64": torch.float64}


def arange(start=0, end=None, step=1, dtype=None, name=None, *,
           device: Optional[Union[str, torch.device]] = None):
    """paddle.arange: ``[start, end)`` by ``step`` (``arange(n)`` is
    ``[0, n)``), int64 for integer bounds unless ``dtype`` says otherwise,
    on ``device`` (CUDA unless the caller passes the CPU or a tensor's
    device)."""
    if end is None:
        start, end = 0, start
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    return torch.arange(start, end, step, dtype=dtype,
                        device=resolve_device(device))
