"""paddle.save / paddle.load (counterpart of ``paddle_tpu/framework/io.py``).

The format is the JAX package's: the magic line ``PDTPU1\\n``, then a
pickle of a pure-numpy tree. Nested dicts, lists and tuples of tensors are
kept; each tensor (a ``Tensor``, a ``Parameter`` or any ``torch.Tensor``)
is stored as a ``_TensorLeaf`` holding its numpy value (a bfloat16 tensor
as float32, which numpy has). ``load`` gives ``Tensor`` on the current
device (``set_device``), or the numpy arrays with ``return_numpy=True``.

Across packages:

- a file that ``paddle_tpu.save`` wrote loads here: its leaves are pickled
  as ``paddle_tpu.framework.io._TensorLeaf``, which the unpickler maps onto
  this module's leaf without importing ``paddle_tpu``;
- departure: a file written here names this module's leaf, so
  ``paddle_tpu.load`` of it returns the port's ``_TensorLeaf`` objects
  (their ``array`` is the value) where it would return ``Tensor``. Making
  that direction exact would need ``paddle_tpu``'s class at pickling time.
"""
from __future__ import annotations

import os
import pickle
import zlib

import numpy as np
import torch

from ..core.tensor import Tensor, _host
from ..utils.fault_injection import fault_point

__all__ = ["save", "load", "crc32_file"]

_MAGIC = b"PDTPU1\n"
#: the JAX package's leaf class, read as this module's
_REFERENCE_LEAF = ("paddle_tpu.framework.io", "_TensorLeaf")


def crc32_file(path, chunk_size=1 << 20):
    """CRC32 of a file's bytes: the checkpoint-integrity checksum."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_size)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


class _TensorLeaf:
    __slots__ = ("array",)

    def __init__(self, array):
        self.array = np.asarray(array)


def _to_numpy_tree(obj):
    if isinstance(obj, Tensor):
        return _TensorLeaf(obj.numpy())
    if isinstance(obj, torch.Tensor):
        return _TensorLeaf(_host(obj))
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_numpy_tree(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_numpy_tree(obj, return_numpy=False):
    if isinstance(obj, _TensorLeaf):
        return obj.array if return_numpy else Tensor(obj.array)
    if isinstance(obj, dict):
        return {k: _from_numpy_tree(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_numpy_tree(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's leaves as this module's; refuses any other
    class of ``paddle_tpu`` (loading it would import JAX)."""

    def find_class(self, module, name):
        if (module, name) == _REFERENCE_LEAF:
            return _TensorLeaf
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads paddle_tpu's tensor "
                "leaves only")
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """paddle.save(state_dict, 'model.pdparams').

    Atomic: the tree is pickled to a same-directory temp file, fsync'd,
    then ``os.replace``'d over ``path``, so a preemption mid-write leaves
    either the old complete file or the new complete file."""
    fault_point("io.save")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            pickle.dump(_to_numpy_tree(obj), f, protocol=protocol)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    fault_point("io.save.post", path=path)


def load(path, return_numpy=False, **configs):
    """paddle.load('model.pdparams')."""
    fault_point("io.load", path=path)
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            f.seek(0)
        obj = _Unpickler(f).load()
    return _from_numpy_tree(obj, return_numpy=return_numpy)
