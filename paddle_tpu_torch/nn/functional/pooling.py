"""Max, average and adaptive pooling in 1, 2 and 3 dimensions
(counterpart of ``paddle_tpu/nn/functional/pooling.py``, which lowers them
to XLA's ``reduce_window`` and a reshape-reduce; no Pallas kernel).

Padding and ``ceil_mode`` are the JAX package's: a padded cell is -inf to
the max, so it never wins; with ``ceil_mode`` the high side is padded
further by whole strides until the last partial window is kept. The
average divides by the cells inside the input when ``exclusive`` and
there is padding, or whenever ``ceil_mode`` added cells (the JAX
package's rule), else by the window's size; ``divisor_override`` is
taken and unused, as there. Adaptive windows run from ``floor(o in /
out)`` to ``ceil((o + 1) in / out)``. On neither AMP list.

Two named departures, both upstream Paddle's function where the JAX
package has none: ``return_mask=True`` on the max pools returns ``(out,
mask)``, the mask the int64 index of each maximum flat within its input
plane (the JAX package takes the flag and returns ``out`` alone); and
"SAME"/"VALID" padding (XLA's SAME: ``ceil(in / stride)`` outputs, the
odd pad at the end), which the JAX package refuses.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else v * n))[:n]
    return (int(v),) * n


def _window_pads(x, kernel, stride, padding, n, ceil_mode):
    """(kernel, stride, [(lo, hi)] per spatial axis of channels-first
    ``x``), the high side extended for ``ceil_mode``."""
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    sizes = x.shape[2:]
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"pool: unknown padding {padding!r}")
        pads = []
        for d, kk, ss in zip(sizes, k, s):
            total = max((math.ceil(d / ss) - 1) * ss + kk - d, 0) \
                if mode == "SAME" else 0
            pads.append((total // 2, total - total // 2))
    else:
        pads = [(p, p) for p in _tuple(padding, n)]
    if ceil_mode:
        for i, (d, kk, ss) in enumerate(zip(sizes, k, s)):
            span = d + sum(pads[i]) - kk
            extra = (-(-span // ss) - span // ss) * ss
            pads[i] = (pads[i][0], pads[i][1] + extra)
    return k, s, pads


def _flat_pads(pads):
    return [v for pair in reversed(pads) for v in pair]


def _unpadded_index(idx, padded, sizes, pads):
    """Flat indices into the padded plane -> flat indices into the input
    plane."""
    out = torch.zeros_like(idx)
    rest = idx
    coords = []
    for size in reversed(padded):
        coords.append(rest % size)
        rest = rest // size
    for c, size, (lo, _) in zip(reversed(coords), sizes, pads):
        out = out * size + (c - lo)
    return out


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, n):
    last = not data_format.startswith("NC")
    if last:
        x = torch.movedim(x, -1, 1)
    k, s, pads = _window_pads(x, kernel_size, stride, padding, n, ceil_mode)
    pool = getattr(torch.nn.functional, f"max_pool{n}d")
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        # PyTorch pads with -inf itself within these bounds
        res = pool(x, k, s, [lo for lo, _ in pads],
                   return_indices=return_mask)
    else:
        xp = torch.nn.functional.pad(x, _flat_pads(pads),
                                     value=float("-inf"))
        res = pool(xp, k, s, 0, return_indices=return_mask)
        if return_mask:
            res = (res[0], _unpadded_index(res[1], xp.shape[2:],
                                           x.shape[2:], pads))
    if not return_mask:
        return torch.movedim(res, 1, -1) if last else res
    out, mask = res
    if last:
        out, mask = torch.movedim(out, 1, -1), torch.movedim(mask, 1, -1)
    return out, mask


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over ``kernel_size`` windows of ``[N, C, H, W]`` (or NHWC)."""
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format, 3)


def _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
              data_format, n):
    last = not data_format.startswith("NC")
    if last:
        x = torch.movedim(x, -1, 1)
    k, s, pads = _window_pads(x, kernel_size, stride, padding, n, ceil_mode)
    pool = getattr(torch.nn.functional, f"avg_pool{n}d")
    flat = _flat_pads(pads)
    out = pool(torch.nn.functional.pad(x, flat), k, s, 0)
    padded = any(lo > 0 for lo, _ in pads) or any(
        hi > 0 for _, hi in pads)
    grew = ceil_mode and any(hi > lo for lo, hi in pads)
    if (exclusive and padded) or grew:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / pool(torch.nn.functional.pad(ones, flat), k, s, 0)
    return torch.movedim(out, 1, -1) if last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format, 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format, 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     data_format, 3)


def _adaptive(x, output_size, n, kind, data_format="NCHW",
              return_mask=False):
    last = not data_format.startswith("NC")
    if last:
        x = torch.movedim(x, -1, 1)
    out = _tuple(output_size, n)
    out = tuple(x.shape[2 + i] if out[i] is None else int(out[i])
                for i in range(n))
    if kind == "avg":
        res = getattr(torch.nn.functional, f"adaptive_avg_pool{n}d")(x, out)
    else:
        res = getattr(torch.nn.functional, f"adaptive_max_pool{n}d")(
            x, out, return_indices=return_mask)
    if return_mask:
        return res
    return torch.movedim(res, 1, -1) if last else res


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the windows ``[floor(o d / out), ceil((o + 1) d / out))``
    of each spatial axis; ``None`` in ``output_size`` keeps that axis."""
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", return_mask=return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", return_mask=return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", return_mask=return_mask)
