"""paddle.fluid.core — the pybind-surface names scripts actually touch
(counterpart of the JAX package's ``paddle/fluid/core.py``).

Reference: paddle/fluid/pybind/ exposed as `fluid.core`. Scripts reach
into it for places and device counts: ``is_compiled_with_cuda()`` is
whether a CUDA device is there (``torch.cuda.is_available()``), which is
what a script asks before it picks ``CUDAPlace(0)``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import CPUPlace, CUDAPlace  # noqa: F401

from .executor import Scope  # noqa: F401

__all__ = [
    "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
    "is_compiled_with_cuda", "get_cuda_device_count", "Scope",
]


def is_compiled_with_cuda() -> bool:
    """Whether a CUDA device is there to run on."""
    return torch.cuda.is_available()


def CUDAPinnedPlace():
    """Pinned host memory: a place on the host, CPUPlace."""
    return CPUPlace()


def get_cuda_device_count() -> int:
    return torch.cuda.device_count()
