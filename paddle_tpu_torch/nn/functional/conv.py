"""Convolutions and transposed convolutions in 1, 2 and 3 dimensions
(counterpart of ``paddle_tpu/nn/functional/conv.py``).

Activations are ``NC...`` or channels-last (``NLC``/``NWC``, ``NHWC``,
``NDHWC``); weights are ``[out, in / groups, k...]`` for a convolution and
Paddle's ``[in, out / groups, k...]`` for a transposed one, in both
packages. The JAX package lowers these to XLA's ``conv_general_dilated``,
not to a Pallas kernel; the port calls ``torch.nn.functional.conv{n}d``
and ``conv_transpose{n}d`` (cuDNN on the card). ``conv1d``/``conv2d``/
``conv3d`` are white-listed for AMP. A float32 convolution on the card
runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False; the
caller sets it.

Padding: an int, ``n`` ints, ``2 n`` ints (before and after per axis), ``n``
pairs (or ``n + 2`` pairs, the first two dropped), or "SAME"/"VALID" as
XLA reads them: for a convolution, SAME gives ``ceil(in / stride)``
outputs with the odd pad at the end; for a transposed one the JAX package
hands XLA the string, which XLA takes at stride 1 only (SAME pads the
input by ``d (k - 1)`` in all, VALID by nothing) and refuses above it:
the port computes the first and raises on the second. A transposed convolution's ``output_size`` is
taken and has no effect, as in the JAX package (``output_padding`` sets
the extra rows).
"""
from __future__ import annotations

import math

import torch

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]),) * n
        if len(v) != n:
            raise ValueError(f"conv: expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _explicit_pads(padding, n):
    """A numeric padding spec -> ``n`` (before, after) pairs."""
    if isinstance(padding, int):
        return ((padding, padding),) * n
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(int(v) for v in p) for p in padding]
        return tuple(pairs[2:] if len(pairs) == n + 2 else pairs)
    if len(padding) == 1:
        return ((int(padding[0]),) * 2,) * n
    if len(padding) == n:
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    raise ValueError(f"conv: bad padding {padding}")


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's SAME: ``ceil(in / stride)`` outputs, the odd pad at the end."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pads(padding, x, weight, stride, dilation):
    """paddle's padding spec for ``x`` (channels first) -> (before, after)
    per spatial axis."""
    n = x.dim() - 2
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0),) * n
        if mode != "SAME":
            raise ValueError(f"conv: unknown padding {padding!r}")
        return _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    return _explicit_pads(padding, n)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    last = not data_format.startswith("NC")
    if last:
        x = torch.movedim(x, -1, 1)
    x, weight, bias = amp.cast_if_amp(f"conv{n}d", (x, weight, bias))
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    pads = _pads(padding, x, weight, stride, dilation)
    if any(lo != hi for lo, hi in pads):
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        x = torch.nn.functional.pad(x, flat)
        pads = ((0, 0),) * n
    conv = getattr(torch.nn.functional, f"conv{n}d")
    out = conv(x, weight, bias, stride, tuple(lo for lo, _ in pads),
               dilation, int(groups))
    return torch.movedim(out, 1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution of ``[N, C, L]`` (or ``NLC``) by ``[out, C / groups,
    k]``, plus ``bias`` ``[out]`` when given."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``[N, C, H, W]`` (or ``NHWC``) by ``[out, C /
    groups, kh, kw]``, plus ``bias`` ``[out]`` when given."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution of ``[N, C, D, H, W]`` (or ``NDHWC``)."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, data_format):
    """The JAX package's transposed convolution: a convolution of the
    input dilated by ``stride`` with the flipped kernel, padded by ``d (k -
    1) - before`` and ``d (k - 1) - after + output_padding``. Computed as
    torch's transposed convolution with no padding (the full output) and
    cut (or zero-extended) to those pads."""
    last = not data_format.startswith("NC")
    if last:
        x = torch.movedim(x, -1, 1)
    stride, dilation = _ntuple(stride, n), _ntuple(dilation, n)
    opad = _ntuple(output_padding if output_padding is not None else 0, n)
    k = weight.shape[2:]
    full = [d * (kk - 1) for d, kk in zip(dilation, k)]
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"conv_transpose: unknown padding {padding!r}")
        if any(st != 1 for st in stride):
            raise ValueError("conv_transpose: string padding with a stride "
                             "above 1 (XLA refuses it in the JAX package)")
        # XLA's string padding over the undilated input at stride 1
        lax = [(f // 2, f - f // 2) if mode == "SAME" else (0, 0)
               for f in full]
    else:
        lax = [(f - lo, f - hi + op) for f, (lo, hi), op in zip(
            full, _explicit_pads(padding, n), opad)]
    conv = getattr(torch.nn.functional, f"conv_transpose{n}d")
    out = conv(x, weight, None, stride, 0, 0, int(groups), dilation)
    for i, (f, (lo, hi)) in enumerate(zip(full, lax)):
        ax = 2 + i
        cut_lo, cut_hi = f - lo, f - hi
        if cut_lo > 0:
            out = out.narrow(ax, cut_lo, out.shape[ax] - cut_lo)
        if cut_hi > 0:
            out = out.narrow(ax, 0, out.shape[ax] - cut_hi)
        if cut_lo < 0 or cut_hi < 0:
            flat = [0, 0] * (out.dim() - 1 - ax) + [max(-cut_lo, 0),
                                                     max(-cut_hi, 0)]
            out = torch.nn.functional.pad(out, flat)
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return torch.movedim(out, 1, -1) if last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """2-D transposed convolution of ``[N, C, H, W]`` (or ``NHWC``) by
    Paddle's ``[C, out / groups, kh, kw]``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format)
