"""Shape manipulation, gathers and scatters (counterpart of
``paddle_tpu/ops/manipulation.py``): every name of its ``__all__``, with
Paddle's meanings where they differ from torch's (``split`` takes a
number of sections or their sizes, ``transpose`` a permutation,
``expand`` a target shape with -1 for a kept axis, ``gather`` rows by an
index vector). Ops whose output size depends on the data (``unique``,
``nonzero``, ``masked_select``) read the host, as in the JAX package;
``masked_select`` keeps its gradient (ones where selected), as Paddle's
does, where the JAX package's has none.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.tensor import Tensor
from ._dispatch import apply, canon_shape, nondiff, raw, raws

__all__ = [
    "as_complex", "as_real", "broadcast_tensors", "broadcast_to", "cast",
    "chunk", "clip_by_norm", "concat", "expand", "expand_as", "flatten",
    "flip", "gather", "gather_nd", "index_sample", "index_select",
    "masked_select", "moveaxis", "nonzero", "pad", "put_along_axis",
    "repeat_interleave", "reshape", "reshape_", "roll", "rot90", "scatter",
    "scatter_nd", "scatter_nd_add", "slice", "split", "squeeze", "stack",
    "strided_slice", "t", "take_along_axis", "tile", "transpose", "unbind",
    "unique", "unsqueeze", "unstack", "where", "tensordot", "diagonal",
    "diag_embed", "unfold", "crop", "shard_index", "unique_consecutive",
    "masked_fill", "index_add", "index_fill", "index_put", "view",
]


def _int(v) -> int:
    return int(raw(v).item()) if isinstance(v, (Tensor, torch.Tensor)) \
        else int(v)


def _long(i):
    return i.long() if i.dtype != torch.bool else i


def reshape(x, shape, name=None):
    shp = canon_shape(shape)
    return apply(lambda a: torch.reshape(a, shp), x, name="reshape")


view = reshape


def reshape_(x, shape, name=None):
    return x.reshape_(shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)

    return apply(f, x, name="flatten")


def transpose(x, perm, name=None):
    perm = tuple(int(p) for p in perm)
    return apply(lambda a: a.permute(perm), x, name="transpose")


def t(x, name=None):
    return apply(lambda a: a.permute(*reversed(range(a.dim()))), x,
                 name="t")


def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        ax = axis if isinstance(axis, (list, tuple)) else [axis]
        return torch.squeeze(a, tuple(int(v) % builtins.max(a.dim(), 1)
                                      for v in ax))

    return apply(f, x, name="squeeze")


def unsqueeze(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    ax = [_int(v) for v in ax]

    def f(a):
        nd = a.dim() + len(ax)
        for d in sorted(v % nd for v in ax):
            a = a.unsqueeze(d)
        return a

    return apply(f, x, name="unsqueeze")


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply(lambda *rs: torch.cat(rs, axis), *x, name="concat")


def stack(x, axis=0, name=None):
    return apply(lambda *rs: torch.stack(rs, axis), *x, name="stack")


def unstack(x, axis=0, num=None, name=None):
    return list(apply(lambda a: tuple(torch.unbind(a, axis)), x,
                      name="unstack"))


def unbind(x, axis=0, name=None):
    return unstack(x, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """Split along ``axis`` into ``num_or_sections`` equal parts (an
    int, which must divide the axis) or parts of the given sizes (one
    of them -1: the rest)."""
    axis = _int(axis)
    dim = raw(x).shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(
                f"paddle.split: axis {axis} length {dim} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - builtins.sum(s for s in sizes if s >= 0)
    return list(apply(lambda a: tuple(torch.split(a, sizes, axis)), x,
                      name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def tile(x, repeat_times, name=None):
    reps = canon_shape(repeat_times)
    return apply(lambda a: torch.tile(a, reps), x, name="tile")


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps an axis of the input (and raises
    on an axis the input does not have)."""
    tgt = list(canon_shape(shape))

    def f(a):
        off = len(tgt) - a.dim()
        out = list(tgt)
        for i, s in enumerate(tgt):
            if s == -1:
                if i < off:
                    raise ValueError(
                        "paddle.expand: -1 is only valid for dims that exist "
                        f"in the input (got -1 at new leading dim {i})")
                out[i] = a.shape[i - off]
        return a.expand(out)

    return apply(f, x, name="expand")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    shp = tuple(raw(y).shape)
    return apply(lambda a: a.expand(shp), x, name="expand_as")


def broadcast_tensors(inputs, name=None):
    return list(apply(lambda *rs: tuple(torch.broadcast_tensors(*rs)),
                      *inputs, name="broadcast_tensors"))


def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply(lambda a: torch.flip(a, ax), x, name="flip")


def roll(x, shifts, axis=None, name=None):
    return apply(lambda a: torch.roll(a, shifts, axis), x, name="roll")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(lambda a: torch.rot90(a, k, tuple(axes)), x, name="rot90")


def cast(x, dtype):
    d = convert_dtype(dtype)
    return apply(lambda a: a.to(d), x, name="cast")


def _index_of(dim, start, stop, step, device):
    return torch.arange(dim, device=device)[start:stop:step] if step > 0 \
        else torch.tensor(list(range(dim)[start:stop:step]),
                          dtype=torch.int64, device=device)


def slice(x, axes, starts, ends, name=None):
    """``x[starts:ends]`` along ``axes`` (bounds clamped to the axis)."""
    spec = [(int(a), _int(s), _int(e)) for a, s, e in zip(axes, starts,
                                                          ends)]

    def f(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, st, en in spec:
            idx[ax] = builtins.slice(st, en)
        return a[tuple(idx)]

    return apply(f, x, name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    """``x[start:end:stride]`` along ``axes``; a negative stride walks
    backwards, as in Python."""
    spec = [(int(a), int(s), int(e), int(st))
            for a, s, e, st in zip(axes, starts, ends, strides)]

    def f(a):
        for ax, st, en, sd in spec:
            a = a.index_select(ax, _index_of(a.shape[ax], st, en, sd,
                                             a.device))
        return a

    return apply(f, x, name="strided_slice")


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    idx = _long(raw(index)).reshape(-1)
    return apply(lambda a: torch.index_select(a, axis, idx.to(a.device)), x,
                 name="gather")


def gather_nd(x, index, name=None):
    idx = _long(raw(index))
    return apply(lambda a: a[tuple(torch.movedim(idx.to(a.device), -1, 0))],
                 x, name="gather_nd")


def take_along_axis(x, indices, axis, name=None):
    idx = _long(raw(indices))
    return apply(lambda a: torch.take_along_dim(a, idx.to(a.device), axis),
                 x, name="take_along_axis")


def put_along_axis(x, indices, values, axis, reduce="assign", name=None):
    """Write ``values`` at ``indices`` along ``axis``: assigned, added
    (``"add"``) or multiplied (``"multiply"``/``"mul"``)."""
    idx = _long(raw(indices))
    if reduce not in ("assign", "add", "multiply", "mul"):
        raise ValueError(f"unknown reduce {reduce}")

    def f(a, v):
        ax = axis % a.dim()
        i = idx.to(a.device)
        v = torch.broadcast_to(v.to(a.dtype), i.shape).contiguous()
        if reduce == "assign":
            return a.scatter(ax, i, v)
        if reduce == "add":
            return a.scatter_add(ax, i, v)
        return a.scatter_reduce(ax, i, v, "prod")

    return apply(f, x, values, name="put_along_axis")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (or, without
    ``overwrite``, zeroed and then summed with the updates for them)."""
    idx = _long(raw(index)).reshape(-1)

    def f(a, u):
        i = idx.to(a.device)
        u = u.to(a.dtype)
        if overwrite:
            return a.index_copy(0, i, u)
        return a.index_fill(0, i, 0).index_add(0, i, u)

    return apply(f, x, updates, name="scatter")


def scatter_nd_add(x, index, updates, name=None):
    idx = _long(raw(index))
    return apply(lambda a, u: a.index_put(
        tuple(torch.movedim(idx.to(a.device), -1, 0)), u.to(a.dtype),
        accumulate=True), x, updates, name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    u = raw(updates)
    base = torch.zeros(canon_shape(shape), dtype=u.dtype, device=u.device)
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0, name=None):
    idx = _long(raw(index))
    return apply(lambda a: torch.index_select(a, axis, idx.to(a.device)),
                 x, name="index_select")


def index_sample(x, index, name=None):
    idx = _long(raw(index))
    return apply(lambda a: torch.gather(a, 1, idx.to(a.device)), x,
                 name="index_sample")


def masked_select(x, mask, name=None):
    return apply(lambda a, m: a[m.bool()], x, mask, name="masked_select")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    cond = raw(condition).bool()
    return apply(lambda a, b: torch.where(cond.to(a.device), a, b), x, y,
                 name="where")


def nonzero(x, as_tuple=False, name=None):
    with torch.no_grad():
        out = apply(lambda a: torch.nonzero(a, as_tuple=bool(as_tuple)), x,
                    name="nonzero")
    return tuple(out) if as_tuple else out


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique`` (sorted), computed on the host as in the JAX
    package; indices and counts in ``dtype``."""
    r = raw(x)
    res = np.unique(r.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    d = convert_dtype(dtype)
    if not isinstance(res, tuple):
        return Tensor._wrap(torch.as_tensor(res, device=r.device))
    return (Tensor._wrap(torch.as_tensor(res[0], device=r.device)),) + tuple(
        Tensor._wrap(torch.as_tensor(v, device=r.device).to(d))
        for v in res[1:])


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle.pad: ``pad`` has a (before, after) pair per axis of ``x``,
    in order, or pairs for the trailing spatial axes (those after N and C
    in an ``NC...`` format, else between N and the channels), the last
    spatial axis first. Modes: constant, reflect, replicate, circular."""
    if isinstance(pad, (Tensor, torch.Tensor)):
        pad = raw(pad).tolist()
    pad = [int(p) for p in pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"paddle.pad: unknown mode {mode!r}")

    def f(a):
        nd = a.dim()
        if len(pad) == 2 * nd:
            widths = {d: (pad[2 * d], pad[2 * d + 1]) for d in range(nd)}
        else:
            spatial = list(range(2, nd)) if data_format.startswith("NC") \
                else list(range(1, nd - 1))
            k = len(pad) // 2
            widths = {d: (pad[2 * i], pad[2 * i + 1])
                      for i, d in enumerate(reversed(spatial[-k:]))}
        dims = sorted(d for d, w in widths.items() if w != (0, 0))
        if not dims:
            return a.clone()
        if mode == "constant":
            flat = []
            for d in reversed(range(nd)):
                flat += list(widths.get(d, (0, 0)))
            return torch.nn.functional.pad(a, flat, value=value)
        # torch pads the trailing 1-3 axes of a batched input: move the
        # padded axes last and fold the rest into one batch axis
        rest = [d for d in range(nd) if d not in dims]
        moved = a.permute(*rest, *dims)
        lead = moved.shape[:len(rest)]
        folded = moved.reshape(1, -1, *moved.shape[len(rest):])
        flat = []
        for d in reversed(dims):
            flat += list(widths[d])
        out = torch.nn.functional.pad(folded, flat, mode=mode)
        out = out.reshape(*lead, *out.shape[2:])
        inv = [0] * nd
        for pos, d in enumerate(rest + dims):
            inv[d] = pos
        return out.permute(*inv)

    return apply(f, x, name="pad")


def clip_by_norm(x, max_norm, name=None):
    def f(a):
        n = torch.sqrt(torch.sum(a * a))
        return torch.where(n > max_norm, a * (max_norm / n), a)

    return apply(f, x, name="clip_by_norm")


def moveaxis(x, source, destination, name=None):
    return apply(lambda a: torch.movedim(a, source, destination), x,
                 name="moveaxis")


def as_complex(x, name=None):
    return apply(lambda a: torch.view_as_complex(a.contiguous()), x,
                 name="as_complex")


def as_real(x, name=None):
    return apply(torch.view_as_real, x, name="as_real")


def repeat_interleave(x, repeats, axis=None, name=None):
    r = raw(repeats) if isinstance(repeats, (Tensor, torch.Tensor)) \
        else repeats
    return apply(lambda a: torch.repeat_interleave(a, r, axis), x,
                 name="repeat_interleave")


def tensordot(x, y, axes=2, name=None):
    return apply(lambda a, b: torch.tensordot(a, b, dims=axes), x, y,
                 name="tensordot")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                 name="diagonal")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return apply(lambda a: torch.diag_embed(a, offset, dim1, dim2), input,
                 name="diag_embed")


def unfold(x, axis, size, step, name=None):
    """Sliding windows of ``size`` by ``step`` along ``axis``: that axis
    counts windows, a new last axis holds each window."""
    return apply(lambda a: a.unfold(axis % a.dim(), size, step), x,
                 name="unfold")


def crop(x, shape=None, offsets=None, name=None):
    r = raw(x)
    shp = canon_shape(shape) if shape is not None else tuple(r.shape)
    offs = canon_shape(offsets) if offsets is not None else (0,) * len(shp)
    shp = tuple(r.shape[i] - offs[i] if d in (-1, None) else d
                for i, d in enumerate(shp))
    idx = tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))
    return apply(lambda a: a[idx], x, name="crop")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Global ids -> ids local to shard ``shard_id`` of ``nshards`` (the
    others -> ``ignore_value``)."""
    if not 0 <= shard_id < nshards:
        raise ValueError(f"shard_id {shard_id} out of range for nshards "
                         f"{nshards}")
    size = (index_num + nshards - 1) // nshards
    return nondiff(lambda ids: torch.where(
        ids // size == shard_id, ids % size,
        torch.full_like(ids, ignore_value)), "shard_index")(input)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    r = raw(x).detach()
    res = torch.unique_consecutive(r, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(res, tuple):
        return Tensor._wrap(res)
    d = convert_dtype(dtype)
    return (Tensor._wrap(res[0]),) + tuple(Tensor._wrap(v.to(d))
                                           for v in res[1:])


def masked_fill(x, mask, value, name=None):
    v = raw(value) if isinstance(value, (Tensor, torch.Tensor)) else value
    return apply(lambda a, m: torch.where(
        m.bool(), torch.as_tensor(v, dtype=a.dtype, device=a.device), a),
        x, mask, name="masked_fill")


def index_add(x, index, axis, value, name=None):
    idx = _long(raw(index))
    return apply(lambda a, v: a.index_add(axis, idx.to(a.device),
                                          v.to(a.dtype)),
                 x, value, name="index_add")


def index_fill(x, index, axis, value, name=None):
    idx = _long(raw(index))
    v = raw(value) if isinstance(value, (Tensor, torch.Tensor)) else value
    return apply(lambda a: a.index_fill(axis, idx.to(a.device), v), x,
                 name="index_fill")


def index_put(x, indices, value, accumulate=False, name=None):
    idxs = tuple(_long(i) for i in raws(*indices))
    return apply(lambda a, v: a.index_put(
        tuple(i.to(a.device) for i in idxs), v.to(a.dtype), accumulate),
        x, value, name="index_put")
