"""The operators and methods of ``Tensor`` (counterpart of
``paddle_tpu/ops/patch.py``): the same dunders and methods, attached to
the port's ``Tensor`` class only (``torch.Tensor`` is left as it is).

In-place forms (``add_``, ``x[i] = v``, ``zero_``...) rebind the
tensor's ``_data`` to the new value, as the JAX package rebinds its
array: with gradients on, a tensor in a graph keeps its history (the new
value is an op of the old), and a leaf that requires grad raises; with
gradients off (``no_grad``) the value is replaced and a leaf stays a
leaf.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, to_torch
from . import creation, linalg, logic, manipulation, math, search


def _attach(name, fn):
    setattr(Tensor, name, fn)


_attach("__add__", lambda self, o: math.add(self, o))
_attach("__radd__", lambda self, o: math.add(o, self))
_attach("__sub__", lambda self, o: math.subtract(self, o))
_attach("__rsub__", lambda self, o: math.subtract(o, self))
_attach("__mul__", lambda self, o: math.multiply(self, o))
_attach("__rmul__", lambda self, o: math.multiply(o, self))
_attach("__truediv__", lambda self, o: math.divide(self, o))
_attach("__rtruediv__", lambda self, o: math.divide(o, self))
_attach("__floordiv__", lambda self, o: math.floor_divide(self, o))
_attach("__rfloordiv__", lambda self, o: math.floor_divide(o, self))
_attach("__mod__", lambda self, o: math.mod(self, o))
_attach("__rmod__", lambda self, o: math.mod(o, self))
_attach("__pow__", lambda self, o: math.pow(self, o))
_attach("__rpow__", lambda self, o: math.pow(o, self))
_attach("__matmul__", lambda self, o: linalg.matmul(self, o))
_attach("__rmatmul__", lambda self, o: linalg.matmul(o, self))
_attach("__neg__", lambda self: math.neg(self))
_attach("__abs__", lambda self: math.abs(self))
_attach("__invert__", lambda self: logic.logical_not(self))

_attach("__eq__", lambda self, o: logic.equal(self, o))
_attach("__ne__", lambda self, o: logic.not_equal(self, o))
_attach("__lt__", lambda self, o: logic.less_than(self, o))
_attach("__le__", lambda self, o: logic.less_equal(self, o))
_attach("__gt__", lambda self, o: logic.greater_than(self, o))
_attach("__ge__", lambda self, o: logic.greater_equal(self, o))
Tensor.__hash__ = lambda self: id(self)  # __eq__ returns a Tensor


def _index(idx):
    if isinstance(idx, tuple):
        return tuple(to_torch(i) for i in idx)
    return to_torch(idx)


def _getitem(self, idx):
    ti = _index(idx)
    return manipulation.apply(lambda a: a[ti], self, name="getitem")


def _requires_grad_leaf(raw: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and raw.requires_grad and raw.is_leaf


def _rebind(self, new: torch.Tensor, old: torch.Tensor) -> None:
    """``_data`` <- ``new``; with gradients off a leaf keeps
    ``requires_grad``."""
    if not torch.is_grad_enabled() and old.requires_grad and \
            not new.requires_grad:
        new = new.requires_grad_(True)
    self._data = new


def _setitem(self, idx, value):
    """``self[idx] = value`` as a new value of ``self``: with gradients
    on, the overwritten elements get no gradient and ``value`` (when it
    requires one) gets theirs."""
    raw = self._data
    if _requires_grad_leaf(raw):
        raise RuntimeError(
            "in-place __setitem__ on a leaf Tensor that requires grad is "
            "not supported; use .detach() or paddle.no_grad()")
    ti = _index(idx)
    v = manipulation.raw(value, raw.device)
    new = raw.clone()
    target = new[ti]
    if isinstance(v, torch.Tensor) and v.numel() == target.numel() \
            and tuple(v.shape) != tuple(target.shape):
        v = v.reshape(target.shape)
    new[ti] = v.to(raw.dtype) if isinstance(v, torch.Tensor) else v
    _rebind(self, new, raw)


_attach("__getitem__", _getitem)
_attach("__setitem__", _setitem)

_METHODS = dict(
    # math
    add=math.add, subtract=math.subtract, multiply=math.multiply,
    divide=math.divide, floor_divide=math.floor_divide, mod=math.mod,
    remainder=math.mod, pow=math.pow, maximum=math.maximum,
    minimum=math.minimum, exp=math.exp, log=math.log, log2=math.log2,
    log10=math.log10, sqrt=math.sqrt, rsqrt=math.rsqrt, square=math.square,
    abs=math.abs, sign=math.sign, reciprocal=math.reciprocal,
    floor=math.floor, ceil=math.ceil, round=math.round, sin=math.sin,
    cos=math.cos, tan=math.tan, tanh=math.tanh, sigmoid=math.sigmoid,
    erf=math.erf, clip=math.clip, scale=math.scale, lerp=math.lerp,
    sum=math.sum, mean=math.mean, prod=math.prod, max=math.max,
    min=math.min, amax=math.amax, amin=math.amin, all=math.all,
    any=math.any, logsumexp=math.logsumexp, std=math.std, var=math.var,
    median=math.median, cumsum=math.cumsum, cumprod=math.cumprod,
    trace=math.trace,
    # manipulation
    reshape=manipulation.reshape, flatten=manipulation.flatten,
    transpose=manipulation.transpose, squeeze=manipulation.squeeze,
    unsqueeze=manipulation.unsqueeze, split=manipulation.split,
    chunk=manipulation.chunk, tile=manipulation.tile,
    expand=manipulation.expand, expand_as=manipulation.expand_as,
    broadcast_to=manipulation.broadcast_to, flip=manipulation.flip,
    roll=manipulation.roll, gather=manipulation.gather,
    gather_nd=manipulation.gather_nd, scatter=manipulation.scatter,
    index_select=manipulation.index_select,
    masked_select=manipulation.masked_select, where=manipulation.where,
    unbind=manipulation.unbind,
    take_along_axis=manipulation.take_along_axis,
    put_along_axis=manipulation.put_along_axis,
    repeat_interleave=manipulation.repeat_interleave,
    unique=manipulation.unique, nonzero=manipulation.nonzero,
    # linalg
    matmul=linalg.matmul, mm=linalg.mm, bmm=linalg.bmm, dot=linalg.dot,
    norm=linalg.norm, dist=linalg.dist, cholesky=linalg.cholesky,
    inverse=linalg.inverse,
    # logic
    equal=logic.equal, not_equal=logic.not_equal,
    less_than=logic.less_than, less_equal=logic.less_equal,
    greater_than=logic.greater_than, greater_equal=logic.greater_equal,
    logical_and=logic.logical_and, logical_or=logic.logical_or,
    logical_not=logic.logical_not, logical_xor=logic.logical_xor,
    isnan=logic.isnan, isinf=logic.isinf, isfinite=logic.isfinite,
    allclose=logic.allclose, isclose=logic.isclose,
    equal_all=logic.equal_all,
    # search
    argmax=search.argmax, argmin=search.argmin, argsort=search.argsort,
    sort=search.sort, topk=search.topk, kthvalue=search.kthvalue,
    mode=search.mode,
    # creation
    tril=creation.tril, triu=creation.triu,
)


def _method(fn):
    def method(self, *args, **kw):
        return fn(self, *args, **kw)

    method.__name__ = fn.__name__
    return method


for _name, _fn in _METHODS.items():
    _attach(_name, _method(_fn))


def _inplace(fn):
    def method(self, *args, **kw):
        raw = self._data
        if _requires_grad_leaf(raw):
            raise RuntimeError(
                "in-place operation on a leaf Tensor that requires grad is "
                "not supported; use .detach() or paddle.no_grad()")
        _rebind(self, fn(Tensor._wrap(raw), *args, **kw)._data, raw)
        return self

    return method


for _name in ("add", "subtract", "multiply", "scale", "clip", "floor", "ceil",
              "exp", "sqrt", "reciprocal", "round", "rsqrt", "flatten",
              "squeeze", "unsqueeze", "tanh", "reshape"):
    _attach(_name + "_", _inplace(_METHODS[_name]))


def _zero_(self):
    with torch.no_grad():
        _rebind(self, torch.zeros_like(self._data), self._data)
    return self


def _fill_(self, value):
    with torch.no_grad():
        _rebind(self, torch.full_like(self._data, value), self._data)
    return self


_attach("zero_", _zero_)
_attach("fill_", _fill_)
