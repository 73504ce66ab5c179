"""Dtype names and the default float type (counterpart of
``paddle_tpu/core/dtype.py``).

Paddle spells a type as a string (``"float32"``, ``"int64"``, aliases such
as ``"fp16"``), a numpy dtype or a framework dtype; here each resolves to a
``torch.dtype``. The default float type is process-global, float32 unless
``set_default_dtype`` says otherwise.

Where the JAX package runs without x64 (int64 and float64 land on int32
and float32), the port keeps 64-bit types, as Paddle does: a Python int
or an int64 array becomes int64. A numpy float64 array or a Python float
becomes the default float type, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype", "default_float_dtype", "is_floating",
           "infer_dtype_from_data"]

_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

_ALIASES = {
    "float": "float32", "double": "float64", "half": "float16",
    "int": "int32", "long": "int64", "bfloat": "bfloat16",
    "bf16": "bfloat16", "fp16": "float16", "fp32": "float32",
    "fp64": "float64",
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """A user type spec (a name, a numpy dtype or type, a ``torch.dtype``)
    -> ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name.startswith("paddle."):
            name = name[len("paddle."):]
        if name not in _NAME_TO_DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[name]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"Cannot interpret {dtype!r} as a dtype") from None
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"Unsupported dtype {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    """Paddle's name of a type (``"float32"``, ``"bool"``, ...)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def set_default_dtype(dtype) -> None:
    """paddle.set_default_dtype: the float type of Python floats, float64
    arrays, creation ops and layer parameters."""
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError("set_default_dtype only accepts floating dtypes")
    _default_dtype = d


def get_default_dtype() -> str:
    return dtype_name(_default_dtype)


def default_float_dtype() -> torch.dtype:
    return _default_dtype


def is_floating(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex


def infer_dtype_from_data(data) -> torch.dtype:
    """The type ``to_tensor`` gives host data: bool -> bool, Python or
    numpy ints -> int64 (an integer array keeps its own width), floats
    and float64 arrays -> the default float type, complex -> complex64;
    any other numpy type is kept."""
    if isinstance(data, (bool, np.bool_)):
        return torch.bool
    if isinstance(data, int):
        return torch.int64
    if isinstance(data, np.integer):
        return convert_dtype(data.dtype)
    if isinstance(data, (float, np.floating)) and not isinstance(
            data, (np.float16, np.float32)):
        return _default_dtype
    if isinstance(data, complex):
        return torch.complex64
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        return _default_dtype
    if arr.dtype == np.complex128:
        return torch.complex64
    if arr.dtype.kind in "OU":
        raise TypeError(f"to_tensor: cannot convert {type(data).__name__} "
                        "data to a tensor")
    return convert_dtype(arr.dtype)
