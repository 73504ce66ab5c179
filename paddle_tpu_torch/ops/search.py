"""Search and sort (counterpart of ``paddle_tpu/ops/search.py``): every
name of its ``__all__``. Sorting is stable, and a descending sort is the
ascending one reversed, as in the JAX package, so ties order alike.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ._dispatch import apply, bool_args, nondiff, raw

__all__ = ["argmax", "argmin", "argsort", "index_of_max", "kthvalue",
           "mode", "searchsorted", "sort", "topk"]


def _arg(tfn, opname):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        d = convert_dtype(dtype)

        def f(a):
            if axis is None:
                return tfn(a.reshape(-1), 0).to(d)
            return tfn(a, axis, keepdim=keepdim).to(d)

        return nondiff(f, opname)(x)

    op.__name__ = opname
    return op


argmax = _arg(bool_args(torch.argmax), "argmax")
argmin = _arg(bool_args(torch.argmin), "argmin")


def argsort(x, axis=-1, descending=False, name=None):
    def f(a):
        r = torch.argsort(a, dim=axis, stable=True)
        return r.flip(axis) if descending else r

    return nondiff(f, "argsort")(x)


def sort(x, axis=-1, descending=False, name=None):
    def f(a):
        r = torch.sort(a, dim=axis, stable=True).values
        return r.flip(axis) if descending else r

    return apply(f, x, name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the ``k`` largest (or smallest) along
    ``axis`` (the last by default); the indices carry no gradient."""
    k = int(raw(k).item()) if not isinstance(k, int) else k
    ax = -1 if axis is None else axis
    vals, idx = apply(lambda a: tuple(torch.topk(a, k, ax, largest, sorted)),
                      x, name="topk")
    idx.stop_gradient = True
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index (in the
    stable ascending order)."""
    def f(a):
        s, si = torch.sort(a, dim=axis, stable=True)
        v = s.select(axis, k - 1)
        i = si.select(axis, k - 1)
        if keepdim:
            v, i = v.unsqueeze(axis), i.unsqueeze(axis)
        return v, i

    vals, idx = apply(f, x, name="kthvalue")
    idx.stop_gradient = True
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` and the index of its first
    occurrence (the JAX package's rule)."""
    def f(a):
        other = axis - 1 if axis < 0 else axis + 1
        cnt = torch.sum(a.unsqueeze(axis) == a.unsqueeze(other), axis)
        best = torch.argmax(cnt, axis, keepdim=True)
        v = torch.take_along_dim(a, best, axis)
        if not keepdim:
            v, best = v.squeeze(axis), best.squeeze(axis)
        return v, best

    return nondiff(f, "mode")(x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return nondiff(lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), "searchsorted")(
            sorted_sequence, values)


def index_of_max(x):
    return argmax(x)
