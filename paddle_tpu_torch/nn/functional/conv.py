"""``conv2d`` (counterpart of ``paddle_tpu/nn/functional/conv.py``).

NCHW activations and ``[out, in / groups, kh, kw]`` weights, the layout of
both packages. The JAX package lowers the convolution to XLA's
``conv_general_dilated``, not to a Pallas kernel; the port calls
``torch.nn.functional.conv2d`` (cuDNN on the card). ``conv2d`` is
white-listed for AMP. A float32 convolution on the card runs in TF32
unless ``torch.backends.cudnn.allow_tf32`` is False; the caller sets it.
"""
from __future__ import annotations

import math

import torch

from ... import amp

__all__ = ["conv2d"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return (int(v[0]),) * 2
        if len(v) != 2:
            raise ValueError(f"conv2d: expected 2 values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * 2


def _pads(padding, x, weight, stride, dilation):
    """paddle's padding spec -> ((top, bottom), (left, right)): an int, two
    or four ints, two pairs (or four, NCHW), or "SAME"/"VALID" (XLA's
    SAME: the output is ceil(in / stride), the odd pad at the end)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0), (0, 0))
        if mode != "SAME":
            raise ValueError(f"conv2d: unknown padding {padding!r}")
        pads = []
        for i in range(2):
            n, k = x.shape[2 + i], weight.shape[2 + i]
            total = max((math.ceil(n / stride[i]) - 1) * stride[i]
                        + (k - 1) * dilation[i] + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding),) * 2
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(int(v) for v in p) for p in padding]
        return tuple(pairs[2:] if len(pairs) == 4 else pairs)
    if len(padding) == 1:
        return ((int(padding[0]),) * 2,) * 2
    if len(padding) == 2:
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 4:
        return ((int(padding[0]), int(padding[1])),
                (int(padding[2]), int(padding[3])))
    raise ValueError(f"conv2d: bad padding {padding}")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``[N, C, H, W]`` by ``[out, C / groups, kh,
    kw]``, plus ``bias`` ``[out]`` when given."""
    if data_format != "NCHW":
        raise NotImplementedError(f"conv2d: data_format {data_format!r} is "
                                  "not ported (NCHW only)")
    x, weight, bias = amp.cast_if_amp("conv2d", (x, weight, bias))
    stride, dilation = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = _pads(padding, x, weight, stride, dilation)
    if pt != pb or pl != pr:
        x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    return torch.nn.functional.conv2d(x, weight, bias, stride, (pt, pl),
                                      dilation, int(groups))
