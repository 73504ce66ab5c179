"""Op dispatch helpers (counterpart of ``paddle_tpu/ops/_dispatch.py``).

Every eager op of the Paddle surface unwraps its ``Tensor`` arguments to
their ``torch.Tensor``, runs torch, and wraps the results, through
``core.autograd.apply`` (the AMP cast by op name, the NaN/Inf check).
A Python scalar beside a tensor stays a scalar, so the tensor's type
wins (``x + 2.0`` keeps float16); host arrays and lists become tensors on
the device of the tensor beside them (the ``set_device`` default when
there is none). ``torch.Tensor`` arguments are taken as they are, so a
``Parameter`` mixes with ``Tensor`` freely; the result is a ``Tensor``.

Promotion. torch refuses integer and bool tensors in ops that compute only
in floats (``std``, ``qr``, ``hypot``, ...) and bool tensors in some
integer ops (``abs``, ``argmax``), where jnp promotes them. An op that
the JAX package computes on such inputs opts into :func:`float_args`
(integer and bool tensors to the default float type, the type jnp gives)
or :func:`bool_args` (bool tensors as uint8, and a uint8 result back to
bool: jnp keeps ``abs``, ``ceil``, ``floor`` and ``trunc`` of a bool
tensor bool).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..core import autograd as AG
from ..core.dtype import default_float_dtype
from ..core.tensor import Tensor, _as_raw

__all__ = ["canon_shape", "raw", "raws", "apply", "unary", "binary",
           "nondiff", "to_float", "float_args", "bool_args"]


def canon_shape(shape):
    """A shape spec (an int, a sequence of ints or 0-d tensors, a
    tensor) -> a tuple of Python ints."""
    if isinstance(shape, (Tensor, torch.Tensor)):
        return tuple(int(v) for v in raw(shape).tolist())
    if isinstance(shape, numbers.Integral):
        return (int(shape),)
    return tuple(int(raw(s).item()) if isinstance(s, (Tensor, torch.Tensor))
                 else int(s) for s in shape)


def _is_tensor(x) -> bool:
    return isinstance(x, (Tensor, torch.Tensor))


def raw(x, device=None) -> torch.Tensor:
    """A ``Tensor`` -> its tensor; a ``torch.Tensor`` as it is; host data
    -> a new tensor on ``device`` (the ``set_device`` default when None),
    typed as ``to_tensor`` types it."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _as_raw(x, device=device)


def raws(*xs):
    """Each argument as a tensor, host data on the device of the first
    tensor among them."""
    dev = next((raw(x).device for x in xs if _is_tensor(x)), None)
    return tuple(raw(x, dev) for x in xs)


def apply(fn, *xs, name=None):
    """``fn`` over the tensors of ``xs`` (host data converted), wrapped."""
    return AG.apply(fn, raws(*xs), name=name)


def unary(fn, opname):
    def op(x, name=None):
        return AG.apply(fn, (raw(x),), name=opname)

    op.__name__ = opname
    return op


def _scalar(v) -> bool:
    return isinstance(v, (numbers.Number, np.number, np.bool_))


def binary(fn, opname):
    """``fn(x, y)`` with a tensor or a Python scalar on either side."""
    def op(x, y, name=None):
        x, y = (v.item() if isinstance(v, np.generic) else v for v in (x, y))
        if _scalar(y) and _is_tensor(x):
            return AG.apply(lambda a: fn(a, y), (raw(x),), name=opname)
        if _scalar(x) and _is_tensor(y):
            return AG.apply(lambda b: fn(x, b), (raw(y),), name=opname)
        return AG.apply(fn, raws(x, y), name=opname)

    op.__name__ = opname
    return op


def nondiff(fn, opname):
    """An op with no gradient (comparisons, integer results): its output
    never requires one."""
    def op(*args, name=None, **kw):
        with torch.no_grad():
            return AG.apply(lambda *r: fn(*r, **kw), raws(*args),
                            name=opname)

    op.__name__ = opname
    return op


def to_float(a):
    """An integer or bool tensor in the default float type; a float or
    complex one, or a non-tensor, as it is."""
    if not isinstance(a, torch.Tensor) or a.is_floating_point() \
            or a.is_complex():
        return a
    return a.to(default_float_dtype())


def float_args(fn):
    """``fn`` with its integer and bool tensor arguments in the default
    float type first."""
    def f(*args, **kw):
        return fn(*(to_float(a) for a in args), **kw)

    return f


def bool_args(fn):
    """``fn`` with its bool tensor arguments as uint8; a uint8 result of
    bool inputs comes back as bool."""
    def f(*args, **kw):
        was_bool = any(isinstance(a, torch.Tensor) and a.dtype == torch.bool
                       for a in args)
        out = fn(*(a.to(torch.uint8) if isinstance(a, torch.Tensor)
                   and a.dtype == torch.bool else a for a in args), **kw)
        return out.bool() if was_bool and out.dtype == torch.uint8 else out

    return f
