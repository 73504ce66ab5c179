"""Elementwise math and reductions (counterpart of
``paddle_tpu/ops/math.py``): every name of its ``__all__``, each a torch op
under the name the JAX package gives it (the AMP and NaN/Inf seam of
``core.autograd.apply``).

Integer and bool inputs promote as the JAX package's do (``_dispatch``'s
``float_args`` and ``bool_args``). Where the two differ: integer
reductions return int64 (the JAX package int32 without x64);
``exponential_`` fills ``x`` in place with Exponential(``lam``) draws
from the package's generator, as Paddle does, where the JAX package
computes ``exp``.
"""
from __future__ import annotations

import builtins

import torch

from ..core import random as rnd
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor
from ._dispatch import (apply, binary, bool_args, float_args, nondiff, raw,
                        raws, to_float, unary)

__all__ = [
    "abs", "acos", "acosh", "add", "all", "amax", "amin", "angle", "any",
    "asin", "asinh", "atan", "atan2", "atanh", "ceil", "clip", "conj",
    "copysign", "cos", "cosh", "count_nonzero", "cummax", "cummin",
    "cumprod", "cumsum", "deg2rad", "diff", "digamma", "divide", "erf",
    "erfinv", "exp", "expm1", "exponential_", "floor", "floor_divide",
    "floor_mod", "fmax", "fmin", "frac", "gcd", "heaviside", "hypot",
    "imag", "increment", "inner", "kron", "lcm", "lerp", "lgamma", "log",
    "log10", "log1p", "log2", "logaddexp", "logit", "logsumexp", "max",
    "maximum", "mean", "median", "min", "minimum", "mod", "multiplex",
    "multiply", "nanmean", "nansum", "neg", "nextafter", "outer", "pow",
    "prod", "quantile", "rad2deg", "real", "reciprocal", "remainder",
    "round", "rsqrt", "scale", "sigmoid", "sign", "sin", "sinh", "sqrt",
    "square", "stanh", "std", "subtract", "sum", "tan", "tanh", "trace",
    "trunc", "var", "logcumsumexp", "nan_to_num", "sgn", "signbit",
    "isposinf", "isneginf", "isreal", "i0", "i0e", "i1", "i1e",
    "polygamma", "trapezoid", "cumulative_trapezoid", "vander", "ldexp",
    "bucketize", "isin", "take", "renorm", "numel", "nanmedian",
    "nanquantile",
]

# -- binary elementwise ------------------------------------------------------
add = binary(torch.add, "add")
subtract = binary(torch.sub, "subtract")
multiply = binary(torch.mul, "multiply")
divide = binary(torch.true_divide, "divide")
floor_divide = binary(torch.floor_divide, "floor_divide")
mod = binary(torch.remainder, "mod")
remainder = mod
floor_mod = mod
pow = binary(torch.pow, "pow")
maximum = binary(torch.maximum, "maximum")
minimum = binary(torch.minimum, "minimum")
fmax = binary(torch.fmax, "fmax")
fmin = binary(torch.fmin, "fmin")
atan2 = binary(torch.atan2, "atan2")
hypot = binary(float_args(torch.hypot), "hypot")
logaddexp = binary(float_args(torch.logaddexp), "logaddexp")
heaviside = binary(lambda a, b: torch.where(
    a > 0, torch.ones_like(a), torch.where(a < 0, torch.zeros_like(a),
                                           torch.as_tensor(b).to(a))),
    "heaviside")
nextafter = binary(float_args(torch.nextafter), "nextafter")
copysign = binary(torch.copysign, "copysign")
gcd = nondiff(torch.gcd, "gcd")
lcm = nondiff(torch.lcm, "lcm")

# -- unary elementwise -------------------------------------------------------
exp = unary(torch.exp, "exp")
expm1 = unary(torch.expm1, "expm1")
log = unary(torch.log, "log")
log2 = unary(torch.log2, "log2")
log10 = unary(torch.log10, "log10")
log1p = unary(torch.log1p, "log1p")
sqrt = unary(torch.sqrt, "sqrt")
rsqrt = unary(torch.rsqrt, "rsqrt")
square = unary(torch.square, "square")
abs = unary(bool_args(torch.abs), "abs")
sign = unary(torch.sign, "sign")
neg = unary(torch.neg, "neg")
reciprocal = unary(torch.reciprocal, "reciprocal")
floor = unary(bool_args(torch.floor), "floor")
ceil = unary(bool_args(torch.ceil), "ceil")
round = unary(torch.round, "round")
trunc = unary(bool_args(torch.trunc), "trunc")
frac = unary(lambda a: a - torch.trunc(a), "frac")
sin = unary(torch.sin, "sin")
cos = unary(torch.cos, "cos")
tan = unary(torch.tan, "tan")
asin = unary(torch.asin, "asin")
acos = unary(torch.acos, "acos")
atan = unary(torch.atan, "atan")
sinh = unary(torch.sinh, "sinh")
cosh = unary(torch.cosh, "cosh")
tanh = unary(torch.tanh, "tanh")
asinh = unary(torch.asinh, "asinh")
acosh = unary(torch.acosh, "acosh")
atanh = unary(torch.atanh, "atanh")
erf = unary(torch.erf, "erf")
erfinv = unary(torch.erfinv, "erfinv")
lgamma = unary(torch.lgamma, "lgamma")
digamma = unary(torch.digamma, "digamma")
sigmoid = unary(torch.sigmoid, "sigmoid")
logit = unary(torch.logit, "logit")
angle = unary(torch.angle, "angle")
conj = unary(lambda a: torch.conj(a).resolve_conj(), "conj")
real = unary(torch.real, "real")
imag = unary(lambda a: torch.imag(a) if a.is_complex()
             else torch.zeros_like(a), "imag")
rad2deg = unary(torch.rad2deg, "rad2deg")
deg2rad = unary(torch.deg2rad, "deg2rad")
sgn = unary(torch.sgn, "sgn")
signbit = nondiff(torch.signbit, "signbit")
isposinf = nondiff(torch.isposinf, "isposinf")
isneginf = nondiff(torch.isneginf, "isneginf")
isreal = nondiff(torch.isreal, "isreal")
i0 = unary(torch.special.i0, "i0")
i0e = unary(torch.special.i0e, "i0e")
i1 = unary(torch.special.i1, "i1")
i1e = unary(torch.special.i1e, "i1e")


def exponential_(x, lam=1.0, name=None):
    """Fill ``x`` in place with Exponential(``lam``) draws (Paddle's
    ``exponential_``; the JAX package computes ``exp`` here)."""
    r = raw(x)
    with torch.no_grad():
        new = torch.empty_like(r).exponential_(
            lam, generator=rnd.default_generator(r.device))
        if isinstance(x, Tensor):
            x.set_value(new)
        else:
            r.copy_(new)
    return x


def increment(x, value=1.0, name=None):
    """``x + value``, written back into ``x`` (returned)."""
    x._data = apply(lambda a: a + value, x, name="increment")._data
    return x


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (``(x + bias) * scale`` when not
    ``bias_after_scale``), then the activation ``act`` if given."""
    s = raw(scale) if isinstance(scale, (Tensor, torch.Tensor)) else scale
    out = apply((lambda a: a * s + bias) if bias_after_scale
                else (lambda a: (a + bias) * s), x, name="scale")
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def clip(x, min=None, max=None, name=None):
    mn, mx = (raw(v) if isinstance(v, (Tensor, torch.Tensor)) else v
              for v in (min, max))
    if mn is None and mx is None:
        return apply(torch.clone, x, name="clip")
    return apply(lambda a: torch.clamp(a, mn, mx), x, name="clip")


def lerp(x, y, weight, name=None):
    if isinstance(weight, (Tensor, torch.Tensor)):
        return apply(lambda a, b, w: a + w * (b - a), x, y, weight,
                     name="lerp")
    return apply(lambda a, b: a + weight * (b - a), x, y, name="lerp")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda a: scale_b * torch.tanh(scale_a * a), x,
                 name="stanh")


def multiplex(inputs, index, name=None):
    """Row ``i`` of the result is row ``i`` of ``inputs[index[i]]``."""
    idx = raw(index).reshape(-1).long()

    def f(*rs):
        s = torch.stack(rs, 0)
        return s[idx, torch.arange(s.shape[1], device=s.device)]

    return apply(f, *inputs, name="multiplex")


# -- reductions --------------------------------------------------------------


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (Tensor, torch.Tensor)):
        axis = raw(axis).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, ax):
    """``ax`` as a tuple of dims (all of them for None)."""
    if ax is None:
        return tuple(range(a.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax, d = _axis(axis), convert_dtype(dtype)
    return apply(lambda a: torch.sum(a, _dims(a, ax), keepdim=keepdim,
                                     dtype=d), x, name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(lambda a: torch.mean(to_float(a), _dims(a, ax),
                                      keepdim=keepdim), x, name="mean")


def prod(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def f(a):
        for d in sorted((v % builtins.max(a.dim(), 1) for v in _dims(a, ax)),
                        reverse=True):
            a = torch.prod(a, d, keepdim=keepdim)
        return a

    return apply(f, x, name="prod")


def _extreme(tfn, opname):
    def op(x, axis=None, keepdim=False, name=None):
        ax = _axis(axis)
        return apply(lambda a: tfn(a, _dims(a, ax), keepdim=keepdim), x,
                     name=opname)

    op.__name__ = opname
    return op


max = _extreme(torch.amax, "max")
min = _extreme(torch.amin, "min")
amax = _extreme(torch.amax, "amax")
amin = _extreme(torch.amin, "amin")


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return nondiff(lambda a: torch.all(a.bool(), _dims(a, ax),
                                       keepdim=keepdim), "all")(x)


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return nondiff(lambda a: torch.any(a.bool(), _dims(a, ax),
                                       keepdim=keepdim), "any")(x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(lambda a: torch.logsumexp(a, _dims(a, ax), keepdim=keepdim),
                 x, name="logsumexp")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: torch.std(
        a, _dims(a, ax), correction=int(unbiased), keepdim=keepdim)), x,
        name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: torch.var(
        a, _dims(a, ax), correction=int(unbiased), keepdim=keepdim)), x,
        name="var")


def _quantile(a, q, ax, keepdim, fn):
    """numpy's quantile (linear interpolation) over the axes ``ax``."""
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        out = fn(a.reshape(-1), qt, 0)
        if keepdim:
            out = out.reshape(out.shape + (1,) * a.dim())
        return out
    dims = sorted(d % a.dim() for d in _dims(a, ax))
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(*rest, *dims).reshape(
        *[a.shape[d] for d in rest], -1)
    out = fn(moved, qt, -1)
    if keepdim:
        shape = list(out.shape)
        for d in dims:
            shape.insert(d + out.dim() - len(rest), 1)
        out = out.reshape(shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: _quantile(a, 0.5, ax, keepdim,
                                                torch.quantile)),
                 x, name="median")


def quantile(x, q, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: _quantile(a, q, ax, keepdim,
                                                torch.quantile)), x,
                 name="quantile")


def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: _quantile(a, 0.5, ax, keepdim,
                                                torch.nanquantile)), x,
                 name="nanmedian")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: _quantile(a, q, ax, keepdim,
                                                torch.nanquantile)),
                 x, name="nanquantile")


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply(float_args(lambda a: torch.nanmean(a, _dims(a, ax),
                                                   keepdim=keepdim)),
                 x, name="nanmean")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax, d = _axis(axis), convert_dtype(dtype)
    return apply(lambda a: torch.nansum(a, _dims(a, ax), keepdim=keepdim,
                                        dtype=d), x, name="nansum")


def _scan(tfn, opname):
    def op(x, axis=None, dtype=None, name=None):
        ax, d = axis, convert_dtype(dtype)

        def f(a):
            if d is not None:
                a = a.to(d)
            return tfn(a.reshape(-1), 0) if ax is None else tfn(a, int(ax))

        return apply(f, x, name=opname)

    op.__name__ = opname
    return op


cumsum = _scan(torch.cumsum, "cumsum")
logcumsumexp = _scan(torch.logcumsumexp, "logcumsumexp")
cummax = _scan(lambda a, d: torch.cummax(a, d).values, "cummax")
cummin = _scan(lambda a, d: torch.cummin(a, d).values, "cummin")


def cumprod(x, dim=None, dtype=None, name=None):
    d = convert_dtype(dtype)

    def f(a):
        if d is not None:
            a = a.to(d)
        return torch.cumprod(a.reshape(-1), 0) if dim is None \
            else torch.cumprod(a, int(dim))

    return apply(f, x, name="cumprod")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)

    def f(a):
        return torch.sum(a != 0, _dims(a, ax), keepdim=keepdim)

    return nondiff(f, "count_nonzero")(x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                 x, name="trace")


def kron(x, y, name=None):
    return apply(torch.kron, x, y, name="kron")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    extra = [v for v in (prepend, append) if v is not None]

    def f(a, *pa):
        it = iter(pa)
        pre = next(it) if prepend is not None else None
        app = next(it) if append is not None else None
        return torch.diff(a, n, axis, pre, app)

    return apply(f, x, *extra, name="diff")


def inner(x, y, name=None):
    return apply(torch.inner, x, y, name="inner")


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x,
                 y, name="outer")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                 name="nan_to_num")


def polygamma(x, n, name=None):
    return apply(lambda a: torch.polygamma(int(n), a), x, name="polygamma")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda yy, xx: torch.trapezoid(yy, xx, dim=axis), y, x,
                     name="trapezoid")
    return apply(lambda yy: torch.trapezoid(
        yy, dx=1.0 if dx is None else dx, dim=axis), y, name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda yy, xx: torch.cumulative_trapezoid(
            yy, xx, dim=axis), y, x, name="cumulative_trapezoid")
    return apply(lambda yy: torch.cumulative_trapezoid(
        yy, dx=1.0 if dx is None else dx, dim=axis), y,
        name="cumulative_trapezoid")


def vander(x, n=None, increasing=False, name=None):
    """Columns ``x ** k``, k from ``n - 1`` down to 0 (up with
    ``increasing``)."""
    def f(a):
        ks = range(a.shape[0] if n is None else n)
        return torch.stack([a ** k for k in (ks if increasing
                                              else reversed(ks))], -1)

    return apply(f, x, name="vander")


ldexp = binary(lambda a, b: torch.ldexp(
    a, torch.as_tensor(b, device=a.device).to(torch.int32)), "ldexp")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return nondiff(lambda a, s: torch.searchsorted(
        s, a, out_int32=out_int32, right=right), "bucketize")(
            x, sorted_sequence)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return nondiff(lambda a, t: torch.isin(
        a, t, assume_unique=assume_unique, invert=invert), "isin")(
            x, test_x)


def take(x, index, mode="raise", name=None):
    """Gather from the flattened ``x``: ``mode="raise"`` checks the
    indices (a host read), ``"wrap"`` wraps them, ``"clip"`` clamps them
    (a negative index to 0)."""
    a, i = raws(x, index)
    n = a.numel()
    if mode == "raise" and i.numel() and (
            int(i.max()) >= n or int(i.min()) < -n):
        raise IndexError(f"take: index out of range for tensor with {n} "
                         "elements")

    def f(t, idx):
        idx = idx.long()
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        elif mode == "clip":
            idx = idx.clamp(0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
        return t.reshape(-1)[idx]

    return apply(f, a, i, name="take")


def renorm(x, p, axis, max_norm, name=None):
    """Scale each slice along ``axis`` whose ``p``-norm exceeds
    ``max_norm`` down to it."""
    def f(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(torch.abs(flat) ** p, 1) ** (1.0 / p)
        factor = torch.where(norms > max_norm,
                             max_norm / torch.clamp(norms, min=1e-12),
                             torch.ones_like(norms))
        return torch.movedim((flat * factor[:, None]).reshape(moved.shape),
                             0, axis)

    return apply(f, x, name="renorm")


def numel(x, name=None):
    return Tensor._wrap(torch.tensor(raw(x).numel(), dtype=torch.int64))
