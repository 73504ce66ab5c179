"""Sequence / ragged ops, the LoD policy (counterpart of
``paddle_tpu/ops/sequence.py``).

Reference: the LoD ragged-batch representation (lod_tensor.h:114) feeding
operators/sequence_ops/ (sequence_pad_op, sequence_unpad_op,
sequence_mask_op, sequence_pool_op, ...). As in the JAX package, the
policy is **dense + lengths/segment-ids**: every ragged value travels as
a padded dense tensor plus an int lengths (or segment-ids) tensor, and the
sequence ops take the lengths explicitly. ``segment_*`` pool the rows of
one segment (sum/mean/max/min); an empty segment gets the identity of its
pool (0, 0, -inf or the integer type's lowest, +inf or its highest), as
``jax.ops.segment_*``.

The ops whose output size depends on the lengths (``sequence_unpad``,
``sequence_expand``, ``sequence_slice``, ``sequence_reshape``, and
``sequence_mask`` / ``segment_*`` without ``maxlen`` / ``num_segments``)
read the lengths on the host, as the JAX package does.

``sequence_conv``'s default ``context_start`` is ``-(context_length //
2)``, upstream Paddle's ``-int(context_length / 2)``: for an even window
the extra context row sits before the centre row (the JAX package's
earlier default, ``-((context_length - 1) // 2)``, put it after; see
ADVICE.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import autograd as AG
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor
from ._dispatch import raw, raws

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_conv", "sequence_expand", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_enumerate",
    "sequence_concat", "sequence_expand_as", "sequence_reshape",
    "sequence_scatter", "sequence_erase",
]


def _host_ints(x) -> np.ndarray:
    return raw(x).detach().cpu().numpy().astype(np.int64)


def _nondiff(fn, *xs):
    with torch.no_grad():
        return AG.apply(fn, raws(*xs))


def _bcast(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A [B, T'] index into dim 1 of ``vals``, expanded over its trailing
    dims (``take_along_axis``'s broadcast)."""
    return idx.reshape(idx.shape + (1,) * (vals.dim() - 2)).expand(
        *idx.shape, *vals.shape[2:])


def _lowest(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _highest(dtype):
    return torch.finfo(dtype).max if dtype.is_floating_point \
        else torch.iinfo(dtype).max


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[N] lengths -> [N, maxlen] 0/1 mask (sequence_mask_op.cc parity).
    ``maxlen=None`` derives it from the lengths on the host."""
    if maxlen is None:
        maxlen = int(_host_ints(x).max())
    d = convert_dtype(dtype)

    def f(lens):
        r = torch.arange(maxlen, device=lens.device)
        return (r[None, :] < lens[..., None]).to(d)

    return _nondiff(f, x)


def sequence_pad(x, pad_value, maxlen, lengths, name=None):
    """Ragged rows (concatenated [total, ...] + lengths) -> padded
    [batch, maxlen, ...] (sequence_pad_op parity; LoD -> lengths).
    Returns (padded, lengths)."""
    pv = float(pad_value) if not isinstance(pad_value, Tensor) else None

    def f(vals, lens, *pvt):
        pad = pvt[0] if pvt else torch.tensor(pv, dtype=vals.dtype,
                                              device=vals.device)
        starts = torch.cat([torch.zeros(1, dtype=lens.dtype,
                                        device=lens.device),
                            torch.cumsum(lens, 0)[:-1]])
        pos = torch.arange(maxlen, device=vals.device)
        idx = starts[:, None] + pos[None, :]
        valid = pos[None, :] < lens[:, None]
        out = vals[idx.clamp(0, vals.shape[0] - 1)]
        mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
        return torch.where(mask, out, pad.to(vals.dtype))

    args = (x, lengths) + ((pad_value,) if pv is None else ())
    padded = AG.apply(f, raws(*args), name="sequence_pad")
    return padded, lengths


def sequence_unpad(x, length, name=None):
    """Padded [batch, maxlen, ...] + lengths -> concatenated [total, ...]
    (sequence_unpad_op parity); the lengths are read on the host."""
    lens = _host_ints(length)

    def f(vals):
        return torch.cat([vals[i, :int(n)] for i, n in enumerate(lens)], 0)

    return AG.apply(f, raws(x), name="sequence_unpad")


def _segment(pool):
    def op(data, segment_ids, name=None, *, num_segments=None):
        n = num_segments
        if n is None:
            n = int(_host_ints(segment_ids).max()) + 1

        def f(vals, ids):
            ids = ids.long()
            shape = (n,) + tuple(vals.shape[1:])
            if pool in ("sum", "mean"):
                s = vals.new_zeros(shape).index_add(0, ids, vals)
                if pool == "sum":
                    return s
                cnt = vals.new_zeros(n).index_add(
                    0, ids, vals.new_ones(vals.shape[0]))
                return s / cnt.clamp(min=1).reshape(
                    (n,) + (1,) * (vals.dim() - 1))
            if vals.dtype.is_floating_point:
                init = float("-inf") if pool == "max" else float("inf")
            else:
                init = _lowest(vals.dtype) if pool == "max" \
                    else _highest(vals.dtype)
            idx = ids.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(
                vals)
            return vals.new_full(shape, init).scatter_reduce(
                0, idx, vals, reduce="amax" if pool == "max" else "amin",
                include_self=False)

        return AG.apply(f, raws(data, segment_ids), name=f"segment_{pool}")

    op.__name__ = f"segment_{pool}"
    return op


segment_sum = _segment("sum")
segment_mean = _segment("mean")
segment_max = _segment("max")
segment_min = _segment("min")


def _mask_for(lens, T):
    pos = torch.arange(T, device=lens.device)
    return pos[None, :] < lens[:, None]  # [B, T]


def sequence_pool(x, pool_type, lengths, name=None):
    """sequence_pool_op.cc in padded form: [B, T, ...] + lengths -> [B, ...].
    pool_type: sum | average/mean | sqrt | max | min | first | last."""
    pt = pool_type.lower()
    if pt == "average":
        pt = "mean"

    def f(vals, lens):
        B, T = vals.shape[0], vals.shape[1]
        mask = _mask_for(lens, T)
        m = mask.reshape(mask.shape + (1,) * (vals.dim() - 2))
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        if pt in ("sum", "mean", "sqrt"):
            s = torch.where(m, vals, zero).sum(1)
            if pt == "sum":
                return s
            denom = lens.clamp(min=1).to(vals.dtype).reshape(
                (B,) + (1,) * (s.dim() - 1))
            return s / denom if pt == "mean" else s / torch.sqrt(denom)
        if pt == "max":
            return torch.where(m, vals, torch.tensor(
                _lowest(vals.dtype), dtype=vals.dtype,
                device=vals.device)).amax(1)
        if pt == "min":
            return torch.where(m, vals, torch.tensor(
                _highest(vals.dtype), dtype=vals.dtype,
                device=vals.device)).amin(1)
        if pt == "first":
            return vals[:, 0]
        if pt == "last":
            idx = (lens - 1).clamp(min=0).long()[:, None]
            return torch.gather(vals, 1, _bcast(idx, vals))[:, 0]
        raise ValueError(f"unknown pool_type {pool_type!r}")

    return AG.apply(f, raws(x, lengths), name="sequence_pool")


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, "first", lengths)


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, "last", lengths)


def sequence_softmax(x, lengths, name=None):
    """sequence_softmax_op.cc: softmax over each row's valid prefix;
    padded positions get 0."""
    def f(vals, lens):
        mask = _mask_for(lens, vals.shape[1])
        mask = mask.reshape(mask.shape + (1,) * (vals.dim() - 2))
        z = torch.where(mask, vals, torch.tensor(-1e30, dtype=vals.dtype,
                                                 device=vals.device))
        z = z - z.amax(1, keepdim=True).detach()
        e = torch.exp(z) * mask.to(vals.dtype)
        return e / e.sum(1, keepdim=True).clamp(min=1e-30)

    return AG.apply(f, raws(x, lengths), name="sequence_softmax")


def sequence_reverse(x, lengths, name=None):
    """sequence_reverse_op.h: reverse each row's valid prefix, keep the
    padding in place."""
    def f(vals, lens):
        T = vals.shape[1]
        pos = torch.arange(T, device=vals.device)
        rev = lens[:, None] - 1 - pos[None, :]
        idx = torch.where(pos[None, :] < lens[:, None], rev,
                          pos[None, :].expand_as(rev))
        return torch.gather(vals, 1, _bcast(idx.clamp(0, T - 1).long(),
                                            vals))

    return AG.apply(f, raws(x, lengths), name="sequence_reverse")


def sequence_conv(x, weight, lengths, context_length, context_start=None,
                  bias=None, name=None):
    """sequence_conv_op in padded form: a context-window projection.

    x [B, T, D]; weight [context_length * D, M]; positions outside the
    row's valid prefix (and outside [0, T)) contribute zeros, matching
    the reference's im2col over sequence boundaries
    (operators/sequence_ops/sequence_conv_op.h ContextProjection)."""
    if context_start is None:
        context_start = -(context_length // 2)
    cs, cl = int(context_start), int(context_length)

    def f(vals, w, lens, *b):
        B, T, D = vals.shape
        mask = _mask_for(lens, T)[..., None]  # [B, T, 1]
        masked = torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                                     device=vals.device))
        pos = torch.arange(T, device=vals.device)
        cols = []
        for k in range(cl):
            off = cs + k
            shifted = masked[:, (pos + off).clamp(0, T - 1)]
            ok = ((pos + off >= 0) & (pos + off < T))[None, :, None]
            ok = ok & (pos[None, :, None] + off < lens[:, None, None])
            cols.append(torch.where(ok, shifted, torch.zeros(
                (), dtype=vals.dtype, device=vals.device)))
        ctx = torch.cat(cols, -1)  # [B, T, cl*D]
        out = torch.einsum("btc,cm->btm", ctx, w.to(ctx.dtype))
        if b:
            out = out + b[0]
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))

    args = (x, weight, lengths) + ((bias,) if bias is not None else ())
    return AG.apply(f, raws(*args), name="sequence_conv")


def sequence_expand(x, lengths, name=None):
    """sequence_expand_op: repeat row i of x ``lengths[i]`` times into a
    concatenated [sum(lengths), ...] tensor (lengths read on the host)."""
    lens = _host_ints(lengths)

    def f(vals):
        return torch.repeat_interleave(
            vals, torch.as_tensor(lens, device=vals.device), dim=0,
            output_size=int(lens.sum()))

    return AG.apply(f, raws(x), name="sequence_expand")


def sequence_slice(x, offset, length, lengths=None, name=None):
    """sequence_slice_op: per-row slice [offset[i], offset[i]+length[i])
    of the valid prefix. Output is padded to max(length) with new
    lengths returned: (sliced, out_lengths)."""
    max_out = int(_host_ints(length).max())

    def f(vals, off, ln):
        T = vals.shape[1]
        pos = torch.arange(max_out, device=vals.device)
        idx = (off[:, None] + pos[None, :]).clamp(0, T - 1).long()
        out = torch.gather(vals, 1, _bcast(idx, vals))
        valid = pos[None, :] < ln[:, None]
        m = valid.reshape(valid.shape + (1,) * (vals.dim() - 2))
        return torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))

    out = AG.apply(f, raws(x, offset, length), name="sequence_slice")
    return out, length


def sequence_enumerate(x, win_size, pad_value=0, lengths=None, name=None):
    """sequence_enumerate_op: [B, T] ids -> [B, T, win_size] sliding
    windows; positions past the row end (or T) fill with pad_value."""
    def f(ids, *ln):
        B, T = ids.shape
        pos = torch.arange(T, device=ids.device)
        lens = ln[0] if ln else torch.full((B,), T, device=ids.device)
        pad = torch.tensor(pad_value, dtype=ids.dtype, device=ids.device)
        wins = [torch.where(pos[None, :] + k < lens[:, None],
                            ids[:, (pos + k).clamp(0, T - 1)], pad)
                for k in range(win_size)]
        return torch.stack(wins, -1)

    return _nondiff(f, *((x,) if lengths is None else (x, lengths)))


def sequence_erase(x, tokens, lengths=None, name=None):
    """sequence_erase_op in padded form: drop every occurrence of the ids
    in ``tokens`` from each row's valid prefix, compacting the survivors
    left (stable order). Output keeps the [B, T] padded shape (zeros past
    the new end); returns (out, new_lengths)."""
    tokens = tuple(int(t) for t in tokens)

    def f(ids, *ln):
        B, T = ids.shape
        pos = torch.arange(T, device=ids.device)
        lens = ln[0] if ln else torch.full((B,), T, dtype=torch.int32,
                                           device=ids.device)
        keep = pos[None, :] < lens[:, None]
        for t in tokens:
            keep = keep & (ids != t)
        order = torch.argsort(torch.where(keep, 0, 1) * T + pos[None, :],
                              dim=1)
        gathered = torch.gather(ids, 1, order)
        new_len = keep.sum(1).to(lens.dtype)
        out = torch.where(pos[None, :] < new_len[:, None], gathered,
                          torch.zeros((), dtype=ids.dtype, device=ids.device))
        return out, new_len

    return _nondiff(f, *((x,) if lengths is None else (x, lengths)))


def sequence_concat(x, name=None):
    """sequence_concat_op: concatenate the VALID prefixes of several
    padded batches row-wise. Input: list of (values [B, T_i, ...],
    lengths [B]); returns (concat [B, sum T_i, ...], lengths [B])."""
    vals = [v for v, _ in x]
    lens = [n for _, n in x]

    def f(*args):
        k = len(args) // 2
        vs, ls = args[:k], args[k:]
        B = vs[0].shape[0]
        T_out = sum(v.shape[1] for v in vs)
        total = sum(ls)
        out = vs[0].new_zeros((B, T_out) + tuple(vs[0].shape[2:]))
        pos = torch.arange(T_out, device=vs[0].device)
        offset = torch.zeros(B, dtype=ls[0].dtype, device=ls[0].device)
        for v, n in zip(vs, ls):
            T = v.shape[1]
            src = (pos[None, :] - offset[:, None]).clamp(0, T - 1).long()
            valid = (pos[None, :] >= offset[:, None]) & (
                pos[None, :] < offset[:, None] + n[:, None])
            gathered = torch.gather(v, 1, _bcast(src, v))
            m = valid.reshape(valid.shape + (1,) * (v.dim() - 2))
            out = torch.where(m, gathered, out)
            offset = offset + n
        return out, total

    out = AG.apply(f, raws(*vals, *lens), name="sequence_concat")
    return out[0], out[1]


def sequence_expand_as(x, y_lengths, name=None):
    """sequence_expand_as_op: repeat row i of x y_lengths[i] times
    (lengths read on the host; the dense sibling of sequence_expand)."""
    return sequence_expand(x, y_lengths)


def sequence_reshape(x, lengths, new_dim, name=None):
    """sequence_reshape_op in padded form: refold each row's valid
    payload to width new_dim; returns (out [B, T2, new_dim], new
    lengths). Row payloads must divide new_dim."""
    D = int(raw(x).shape[-1])
    nd = int(new_dim)
    lens = _host_ints(lengths)
    if ((lens * D) % nd).any():
        raise ValueError(
            "sequence_reshape: every row payload (length * dim) must be "
            f"divisible by new_dim={nd}"
        )
    T2 = int((lens * D).max() // nd)

    def f(vals, ls):
        B, T = vals.shape[0], vals.shape[1]
        out = vals.reshape(B, T * D)[:, :T2 * nd].reshape(B, T2, nd)
        pos = torch.arange(T2, device=vals.device)
        new_l = (ls * D) // nd
        m = (pos[None, :] < new_l[:, None])[..., None]
        return torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device)), new_l

    out = AG.apply(f, raws(x, lengths), name="sequence_reshape")
    return out[0], out[1]


def sequence_scatter(x, index, updates, index_lengths=None, name=None):
    """sequence_scatter_op in dense form: x [B, D] += scatter of
    updates [B, T] at per-row positions index [B, T] (padded positions
    masked by index_lengths)."""
    def f(a, idx, upd, *ln):
        T = idx.shape[1]
        if ln:
            mask = (torch.arange(T, device=idx.device)[None, :]
                    < ln[0][:, None]).to(upd.dtype)
        else:
            mask = torch.ones_like(upd)
        return a.scatter_add(1, idx.long(), upd * mask)

    args = (x, index, updates) + (
        (index_lengths,) if index_lengths is not None else ())
    return AG.apply(f, raws(*args), name="sequence_scatter")
