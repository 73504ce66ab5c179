"""The eager ``Tensor`` of the Paddle surface and the Paddle-facing
``Parameter`` (counterparts of ``paddle_tpu/core/tensor.py``).

``Tensor`` is a Python handle over a ``torch.Tensor`` in ``_data``, as the
JAX package's is a handle over a ``jax.Array``. It is not a
``torch.Tensor`` subclass: Paddle's ``split``, ``gather``, ``scatter``,
``transpose``, ``max``, ``expand``, ``size`` and ``shape`` mean other
things than torch's, and the port's own modules call torch's. The
operators and methods (``x + y``, ``x.sum(axis=)``, ``x.reshape([..])``)
are attached by ``ops/patch.py``.

- ``stop_gradient`` is ``not _data.requires_grad`` (True by default);
  ``.grad`` wraps ``_data.grad`` of a leaf; ``backward()`` runs torch's
  engine (``core/autograd.py``). Integer tensors carry no gradient.
- In-place methods (``add_``, ``x[i] = v``) rebind ``_data`` to the new
  value, as the JAX package rebinds its array: the old value's graph
  stays intact, and on a leaf that requires grad they raise unless
  gradients are off.
- ``numpy()`` detaches and copies to the host (a bfloat16 tensor as
  float32: numpy has no bfloat16).

``Parameter`` is a ``torch.nn.Parameter`` subclass, so torch's optimizer
paths, ``jit.TrainStep`` and autograd keep working on it; it adds Paddle's
``name``, ``stop_gradient``, ``trainable``, ``numpy()``, ``gradient()``,
``set_value``, ``optimize_attr``, ``regularizer`` and ``need_clip``.

:func:`to_torch` and :func:`wrap_like` are the boundary of the port's
torch-native layers and functionals: ``Tensor`` arguments in, ``Tensor``
results out when an argument was one; plain ``torch.Tensor`` calls pass
through untouched.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import autograd
from .device import Place, resolve_device
from .dtype import convert_dtype, dtype_name, infer_dtype_from_data

__all__ = ["Tensor", "Parameter", "to_tensor", "to_torch", "wrap_like",
           "tensor_boundary"]


def _host(raw: torch.Tensor) -> np.ndarray:
    """A copy on the host (detached, conjugation resolved; bfloat16 as
    float32, which numpy has), sharing no memory with ``raw``."""
    if raw.dtype == torch.bfloat16:
        raw = raw.detach().float()
    out = torch.Tensor.numpy(raw, force=True)
    return out.copy() if raw.device.type == "cpu" else out


def _as_raw(data, dtype=None, device=None) -> torch.Tensor:
    """Host or tensor data -> a torch tensor of ``dtype`` on ``device``
    (the ``set_device`` default when None)."""
    dev = resolve_device(device)
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        return data.detach().to(device=dev, dtype=convert_dtype(dtype)
                                or data.dtype)
    d = convert_dtype(dtype) if dtype is not None \
        else infer_dtype_from_data(data)
    if isinstance(data, (list, tuple)) and any(
            isinstance(v, (Tensor, torch.Tensor)) for v in data):
        data = [_host(to_torch(v)) for v in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64 and d == torch.bfloat16:
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=dev, dtype=d)


class Tensor:
    # numpy defers to the reflected dunders instead of absorbing the
    # Tensor through __array__ (which would detach it from the graph)
    __array_priority__ = 100
    __array_ufunc__ = None

    __slots__ = ("_data", "name", "persistable", "_backward_ran",
                 "__weakref__")

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None):
        raw = _as_raw(data, dtype, place)
        self._data = raw
        self.name = name
        self.persistable = False
        self._backward_ran = False
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, raw: torch.Tensor, name=None) -> "Tensor":
        t = cls.__new__(cls)
        t._data = raw
        t.name = name
        t.persistable = False
        t._backward_ran = False
        return t

    # -- metadata -------------------------------------------------------
    @property
    def data(self):
        return self

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.dim()

    def dim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def place(self) -> Place:
        dev = self._data.device
        return Place("cpu", 0) if dev.type == "cpu" \
            else Place("gpu", dev.index or 0)

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        raw = self._data
        if value:
            if raw.requires_grad:
                self._data = raw.detach()
        elif not raw.requires_grad and (raw.is_floating_point()
                                        or raw.is_complex()):
            if not raw.is_leaf:
                raw = raw.detach()
            self._data = raw.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        raw = self._data
        if not raw.is_leaf or raw.grad is None:
            return None
        return Tensor._wrap(raw.grad)

    @grad.setter
    def grad(self, value) -> None:
        self._data.grad = None if value is None else to_torch(value)

    def numel(self) -> "Tensor":
        return Tensor._wrap(torch.tensor(self._data.numel(),
                                         dtype=torch.int64))

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        if self._data.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        for i in range(self._data.shape[0]):
            yield self[i]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"{_host(self._data)})")

    # -- host interop ---------------------------------------------------
    def numpy(self) -> np.ndarray:
        return _host(self._data)

    def item(self, *args):
        return _host(self._data).item(*args)

    def tolist(self):
        return _host(self._data).tolist()

    def __array__(self, dtype=None, copy=None):
        a = _host(self._data)
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __bool__(self):
        return bool(self._data.item())

    def __index__(self):
        return int(self._data.item())

    # -- autograd -------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False) -> None:
        """Accumulate this tensor's gradients into the leaves' ``.grad``
        (seeded with ones for a non-scalar)."""
        autograd.run_backward(self, grad_tensor, retain_graph=retain_graph)
        # optimizer.minimize(loss) applies the gradients of a loss whose
        # backward already ran instead of running it again
        self._backward_ran = True

    def gradient(self) -> Optional[np.ndarray]:
        g = self.grad
        return None if g is None else g.numpy()

    def clear_grad(self) -> None:
        self._data.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad) -> None or a replacement``, called once per
        backward with this tensor's whole gradient. Returns a handle
        with ``remove()``."""
        def call(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else to_torch(out)

        return self._data.register_hook(call)

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach(), name=self.name)

    def clone(self) -> "Tensor":
        return autograd.apply(torch.clone, (self._data,), name="clone")

    def set_value(self, value) -> None:
        """Overwrite the value (a data operation, not a recorded op): the
        tensor keeps its type, device and ``stop_gradient`` and leaves any
        graph it was part of."""
        with torch.no_grad():
            new = _as_raw(value, self._data.dtype, self._data.device)
        if tuple(new.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(new.shape)} "
                             f"vs {tuple(self._data.shape)}")
        self._data = new.requires_grad_(self._data.requires_grad)

    def copy_(self, other, blocking=True) -> "Tensor":
        self.set_value(other)
        return self

    # -- type and device ------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        d = convert_dtype(dtype)
        return autograd.apply(lambda a: a.to(d), (self._data,), name="cast")

    def cast(self, dtype) -> "Tensor":
        return self.astype(dtype)

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._data.cpu())

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        return Tensor._wrap(self._data.to(resolve_device(
            "cuda" if device_id is None else f"cuda:{int(device_id)}")))

    def pin_memory(self) -> "Tensor":
        return self

    def value(self):
        return self

    def get_tensor(self):
        return self


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: host data (a list, numpy array or scalar), a
    ``torch.Tensor`` or a ``Tensor`` -> a new ``Tensor`` on ``place`` (the
    ``set_device`` default when None), typed as
    ``core.dtype.infer_dtype_from_data`` says unless ``dtype`` is given."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


class Parameter(torch.nn.Parameter):
    """A trainable ``torch.nn.Parameter`` with Paddle's attributes
    (``trainable`` is ``requires_grad``, ``stop_gradient`` its negation).
    ``.grad`` stays torch's: the engine writes it."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        p = super().__new__(cls, data, requires_grad)
        p.__dict__.update(_pname=name, optimize_attr={"learning_rate": 1.0},
                          regularizer=None, need_clip=True)
        return p

    # torch's TensorBase has a read-only ``name``; Paddle's is the
    # parameter's name
    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    @property
    def persistable(self) -> bool:
        return True

    def numpy(self) -> np.ndarray:
        return _host(self)

    def gradient(self) -> Optional[np.ndarray]:
        return None if self.grad is None else _host(self.grad)

    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad

    @torch.no_grad()
    def set_value(self, value) -> None:
        """Copy ``value`` into the parameter in place (its storage, type
        and device stay)."""
        new = _as_raw(value, self.dtype, self.device)
        if tuple(new.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(new.shape)} "
                             f"vs {tuple(self.shape)}")
        self.copy_(new)


# -- the boundary of torch-native code --------------------------------------


def to_torch(x):
    """A ``Tensor`` -> its ``torch.Tensor``; anything else as it is."""
    return x._data if isinstance(x, Tensor) else x


def _unwrap(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (tuple, list)) and any(
            isinstance(v, (Tensor, tuple, list)) for v in x):
        vals = [_unwrap(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def wrap_like(x):
    """``torch.Tensor`` results (also inside tuples, lists and
    namedtuples) -> ``Tensor``."""
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    if isinstance(x, (tuple, list)):
        vals = [wrap_like(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def _has_tensor(args, kwargs) -> bool:
    for v in (*args, *kwargs.values()):
        if isinstance(v, Tensor) or (isinstance(v, (tuple, list)) and any(
                isinstance(u, Tensor) for u in v)):
            return True
    return False


def tensor_boundary(fn):
    """Decorate a torch-native function so that ``Tensor`` arguments go in
    as their ``torch.Tensor`` and, when one did, the results come back as
    ``Tensor``. A call with no ``Tensor`` is ``fn`` itself."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _has_tensor(args, kwargs):
            return fn(*args, **kwargs)
        return wrap_like(fn(*_unwrap(args), **{
            k: _unwrap(v) for k, v in kwargs.items()}))

    return call
