"""Tensor creation (counterpart of ``paddle_tpu/ops/creation.py``): every
name of its ``__all__``.

New tensors land on the ``set_device`` default; float results take the
default float type and integer ones int64 unless ``dtype`` says otherwise
(the JAX package gives int32 without x64). The random ops draw from the
package's generator of that device (``paddle.seed``), or, for
``uniform(seed=s)`` with ``s`` nonzero, from a generator seeded with
``s``; their numbers are not JAX's.
"""
from __future__ import annotations

import numbers

import torch

from ..core import random as rnd
from ..core.device import resolve_device
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.tensor import Tensor, to_tensor
from ._dispatch import apply, canon_shape as _shape, float_args, raw

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace", "eye",
    "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
    "rand", "randn", "randint", "randperm", "uniform", "normal",
    "bernoulli", "multinomial", "standard_normal", "tril_indices",
    "triu_indices", "poisson", "polar", "complex",
]


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else default_float_dtype()
    return convert_dtype(dtype)


def _new(raw_tensor) -> Tensor:
    return Tensor._wrap(raw_tensor)


def _dev():
    return resolve_device(None)


def _gen():
    return rnd.default_generator(_dev())


def _value(v):
    return raw(v).item() if isinstance(v, (Tensor, torch.Tensor)) else v


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def _fill_dtype(v):
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, numbers.Integral):
        return torch.int64
    return None


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _value(fill_value)
    d = _dt(dtype, _fill_dtype(fill_value))
    return _new(torch.full(_shape(shape), fill_value, dtype=d,
                           device=_dev()))


def empty(shape, dtype=None, name=None):
    """Zeros, as in the JAX package (XLA has no uninitialized memory)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    d = _dt(dtype, raw(x).dtype)
    return apply(lambda r: torch.zeros_like(r, dtype=d), x,
                 name="zeros_like")


def ones_like(x, dtype=None, name=None):
    d = _dt(dtype, raw(x).dtype)
    return apply(lambda r: torch.ones_like(r, dtype=d), x, name="ones_like")


def full_like(x, fill_value, dtype=None, name=None):
    d, v = _dt(dtype, raw(x).dtype), _value(fill_value)
    return apply(lambda r: torch.full_like(r, v, dtype=d), x,
                 name="full_like")


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _value(start), _value(end), _value(step)
    if end is None:
        start, end = 0, start
    ints = all(isinstance(v, numbers.Integral) for v in (start, end, step))
    d = _dt(dtype, torch.int64 if ints else None)
    return _new(torch.arange(start, end, step, dtype=d, device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_value(start), _value(stop), int(_value(num)),
                               dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        d = torch.diag(a, offset)
        if padding_value != 0 and a.dim() == 1:
            on = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            d = torch.where(on, d, torch.full_like(d, padding_value))
        return d

    return apply(f, x, name="diag")


def diagflat(x, offset=0, name=None):
    return apply(lambda a: torch.diagflat(a, offset), x, name="diagflat")


def tril(x, diagonal=0, name=None):
    return apply(lambda a: torch.tril(a, diagonal), x, name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda a: torch.triu(a, diagonal), x, name="triu")


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply(lambda *rs: tuple(torch.meshgrid(*rs, indexing="ij")),
                      *args, name="meshgrid"))


def assign(x, output=None):
    """paddle.assign: a copy of ``x`` (host data too), or written into
    ``output``."""
    src = x if isinstance(x, Tensor) else to_tensor(
        raw(x).detach() if isinstance(x, torch.Tensor) else x)
    if output is None:
        return src.clone()
    output.set_value(src)
    return output


def clone(x, name=None):
    return apply(torch.clone, x, name="clone")


# -- random ------------------------------------------------------------------


def rand(shape, dtype=None, name=None):
    return _new(rnd.rand(_shape(shape), device=_dev(), dtype=_dt(dtype)))


def randn(shape, dtype=None, name=None):
    return _new(rnd.randn(_shape(shape), device=_dev(), dtype=_dt(dtype)))


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _new(torch.randint(int(low), int(high), _shape(shape),
                              generator=_gen(), device=_dev(),
                              dtype=_dt(dtype, torch.int64)))


def randperm(n, dtype=None, name=None):
    return _new(torch.randperm(int(n), generator=_gen(), device=_dev(),
                               dtype=_dt(dtype, torch.int64)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    u = rnd.rand(_shape(shape), device=_dev(), dtype=_dt(dtype),
                 seed=int(seed))
    return _new(u * (max - min) + min)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, (Tensor, torch.Tensor)) or isinstance(
            std, (Tensor, torch.Tensor)):
        m, s = (raw(v) if isinstance(v, (Tensor, torch.Tensor))
                else torch.tensor(v) for v in (mean, std))
        shp = torch.broadcast_shapes(m.shape, s.shape)
        dev = m.device if isinstance(mean, (Tensor, torch.Tensor)) \
            else s.device
        z = torch.randn(shp, generator=rnd.default_generator(dev),
                        device=dev, dtype=default_float_dtype())
        return _new(z * s.to(dev) + m.to(dev))
    shp = _shape(shape) if shape is not None else ()
    return _new(rnd.randn(shp, device=_dev(), dtype=default_float_dtype())
                * std + mean)


def bernoulli(x, name=None):
    r = raw(x).detach()
    return _new(torch.bernoulli(r, generator=rnd.default_generator(
        r.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    r = raw(x).detach()
    return _new(torch.multinomial(r, int(num_samples), replacement,
                                  generator=rnd.default_generator(r.device)))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _new(torch.tril_indices(row, col, offset, device=_dev(),
                                   dtype=convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _new(torch.triu_indices(row, col, offset, device=_dev(),
                                   dtype=convert_dtype(dtype)))


def poisson(x, name=None):
    """A Poisson draw per element, with rate ``x``."""
    r = raw(x).detach()
    return _new(torch.poisson(r, generator=rnd.default_generator(r.device)))


def polar(abs, angle, name=None):
    return apply(float_args(torch.polar), abs, angle, name="polar")


def complex(real, imag, name=None):
    return apply(torch.complex, real, imag, name="complex")
