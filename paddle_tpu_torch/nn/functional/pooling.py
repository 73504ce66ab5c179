"""``max_pool2d`` and ``adaptive_avg_pool2d`` (counterparts of
``paddle_tpu/nn/functional/pooling.py``, which lowers them to XLA's
``reduce_window`` and a reshape-mean; no Pallas kernel).

Padding semantics are the JAX package's: a padded cell is -inf to the
max, so it never wins; with ``ceil_mode`` the high side is padded further
by whole strides until the last partial window is kept. On neither AMP
list: a bfloat16 input pools in bfloat16.
"""
from __future__ import annotations

import torch

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == 2 else v * 2))[:2]
    return (int(v),) * 2


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over ``kernel_size`` windows of ``[N, C, H, W]``."""
    if data_format != "NCHW" or return_mask:
        raise NotImplementedError("max_pool2d: NCHW without return_mask "
                                  "only")
    if isinstance(padding, str):
        raise NotImplementedError("string padding for pool: use int/list")
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    p = _pair(padding)
    extra = [0, 0]
    if ceil_mode:
        for i in range(2):
            span = x.shape[2 + i] + 2 * p[i] - k[i]
            extra[i] = (-(-span // s[i]) - span // s[i]) * s[i]
    if extra == [0, 0] and all(2 * p[i] <= k[i] for i in range(2)):
        # PyTorch pads with -inf itself within these bounds
        return torch.nn.functional.max_pool2d(x, k, s, p)
    x = torch.nn.functional.pad(
        x, (p[1], p[1] + extra[1], p[0], p[0] + extra[0]),
        value=float("-inf"))
    return torch.nn.functional.max_pool2d(x, k, s, 0)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the windows ``[floor(o d / out), ceil((o + 1) d / out))``
    of each spatial axis (a reshape-mean when the sizes divide, as in the
    JAX package); ``None`` in ``output_size`` keeps that axis."""
    if data_format != "NCHW":
        raise NotImplementedError("adaptive_avg_pool2d: NCHW only")
    out = output_size if isinstance(output_size, (list, tuple)) \
        else (output_size, output_size)
    out = tuple(x.shape[2 + i] if out[i] is None else int(out[i])
                for i in range(2))
    return torch.nn.functional.adaptive_avg_pool2d(x, out)
