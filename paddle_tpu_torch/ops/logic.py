"""Comparisons and logical ops (counterpart of
``paddle_tpu/ops/logic.py``): every name of its ``__all__``; none carries
a gradient.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._dispatch import binary, nondiff, raw

__all__ = [
    "allclose", "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor",
    "equal", "equal_all", "greater_equal", "greater_than", "is_empty",
    "is_tensor", "isclose", "isfinite", "isinf", "isnan", "less_equal",
    "less_than", "logical_and", "logical_not", "logical_or",
    "logical_xor", "not_equal",
]


# boolean and integer results: torch records no gradient for them
equal = binary(torch.eq, "equal")
not_equal = binary(torch.ne, "not_equal")
less_than = binary(torch.lt, "less_than")
less_equal = binary(torch.le, "less_equal")
greater_than = binary(torch.gt, "greater_than")
greater_equal = binary(torch.ge, "greater_equal")
logical_and = binary(torch.logical_and, "logical_and")
logical_or = binary(torch.logical_or, "logical_or")
logical_xor = binary(torch.logical_xor, "logical_xor")
bitwise_and = binary(torch.bitwise_and, "bitwise_and")
bitwise_or = binary(torch.bitwise_or, "bitwise_or")
bitwise_xor = binary(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, out=None, name=None):
    return nondiff(torch.logical_not, "logical_not")(x)


def bitwise_not(x, out=None, name=None):
    return nondiff(torch.bitwise_not, "bitwise_not")(x)


isnan = nondiff(torch.isnan, "isnan")
isinf = nondiff(torch.isinf, "isinf")
isfinite = nondiff(torch.isfinite, "isfinite")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return nondiff(lambda a, b: torch.isclose(a, b, rtol, atol, equal_nan),
                   "isclose")(x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor (computed on the device, no host read)."""
    return nondiff(lambda a, b: torch.isclose(
        a, b, rtol, atol, equal_nan).all(), "allclose")(x, y)


def equal_all(x, y, name=None):
    def f(a, b):
        if a.shape != b.shape:
            return torch.tensor(False, device=a.device)
        return (a == b).all()

    return nondiff(f, "equal_all")(x, y)


def is_empty(x, name=None):
    r = raw(x)
    return Tensor._wrap(torch.tensor(r.numel() == 0, device=r.device))


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)
