"""Batch norm, the LayerNorm functionals and their route to the
hand-written kernels, and group, instance, local-response and Lp
normalization.

Counterpart of ``paddle_tpu/nn/functional/norm.py``'s ``batch_norm``,
``layer_norm``, ``fused_residual_layer_norm`` and ``_fused_ln_route``
(single device:
the shard_map seam of the JAX package belongs to a later slice). A routed
call goes through the autograd Functions of ``ops/kernels/layer_norm.py``
on both devices, so its backward runs the B7 kernel.

AMP, as in the JAX package: the dense ``layer_norm`` is black-listed
(float32 in, float32 out); the routed forms are on neither list, so the
kernels take their inputs in the type they come in. Under AMP O1 the
pre-LN block's residual seam meets a float32 residual stream ``x`` and a
bfloat16 attention branch: that pair goes to the B6 kernel as it is, which
returns ``s`` and ``LN(s)`` in ``x``'s type (float16 branches alike).

``batch_norm`` is on neither AMP list. It is written in plain tensor ops,
as the JAX package writes it, because ``torch.nn.functional.batch_norm``
computes another function: it updates the running variance with the
unbiased batch variance, weighs the running statistics by ``1 -
momentum``, and applies the normalization in float32.
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import torch

from ... import amp
from ...ops.kernels import layer_norm as _ln

__all__ = ["batch_norm", "layer_norm", "fused_residual_layer_norm",
           "group_norm", "instance_norm", "normalize", "local_response_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalization over every axis but the channel axis (1 for
    ``NC...``, the last otherwise).

    With batch statistics (``training`` and not ``use_global_stats``), as
    the JAX package: the mean and the biased variance ``mean(x^2) -
    mean^2`` in float32, the normalization folded into ``x * scale +
    shift`` with per-channel ``scale = weight * rsqrt(var + eps)`` and
    ``shift = bias - mean * scale`` cast to x's type (so a bfloat16 input
    is normalized in bfloat16), and the running statistics updated in
    place, ``running * momentum + batch * (1 - momentum)``. Otherwise
    ``(x - running_mean) / sqrt(running_var + eps) * weight + bias``."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]
    if training and not use_global_stats:
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = ((xf * xf).mean(dim=axes) - mean * mean).clamp(min=0.0)
        r = torch.rsqrt(var + epsilon)
        scale = weight.float() * r if weight is not None else r
        shift = bias.float() - mean * scale if bias is not None \
            else -mean * scale
        out = x * scale.to(x.dtype).reshape(bshape) \
            + shift.to(x.dtype).reshape(bshape)
        with torch.no_grad():
            running_mean.copy_(running_mean * momentum
                               + mean * (1 - momentum))
            running_var.copy_(running_var * momentum + var * (1 - momentum))
        return out
    out = (x - running_mean.reshape(bshape)) \
        / torch.sqrt(running_var.reshape(bshape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


def sync_batch_norm(x, running_mean, running_var, weight, bias, group,
                    momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    """:func:`batch_norm`'s training form over the whole batch of the
    ranks of ``group`` (a ``distributed.comm.Group``): each channel's sum,
    sum of squares and count, in float32, all-reduced (the backward
    all-reduces their gradients), then the same folded normalization and
    running-statistics update."""
    from ...distributed.parallel import all_reduce_sum

    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]
    xf = x.float()
    n = torch.tensor([float(x.numel() // x.shape[ch])], device=x.device)
    sums = all_reduce_sum(torch.cat([xf.sum(dim=axes),
                                     (xf * xf).sum(dim=axes), n]), group)
    C = x.shape[ch]
    count = sums[2 * C]
    mean = sums[:C] / count
    var = (sums[C:2 * C] / count - mean * mean).clamp(min=0.0)
    r = torch.rsqrt(var + epsilon)
    scale = weight.float() * r if weight is not None else r
    shift = bias.float() - mean * scale if bias is not None \
        else -mean * scale
    out = x * scale.to(x.dtype).reshape(bshape) \
        + shift.to(x.dtype).reshape(bshape)
    with torch.no_grad():
        running_mean.copy_(running_mean * momentum + mean * (1 - momentum))
        running_var.copy_(running_var * momentum + var * (1 - momentum))
    return out


def _fused_ln_route(x: torch.Tensor, normalized_shape, weight, bias) -> bool:
    """Route this LayerNorm to the B5/B6 kernel wrappers?

    The JAX package's eligibility rule, unchanged: last-axis-only
    normalization with both affine params, float32 or bfloat16, D % 128
    == 0 and rows a multiple of 8 (float32) or 16 (bfloat16).
    ``PADDLE_FUSED_LN=0`` keeps the dense path everywhere, and
    ``PADDLE_FLASH_SHARD=0`` in a job of several ranks (counted in
    ``attention.SHARD_DECLINES``). "Backend has the kernel" is a CUDA
    tensor; on the CPU ``PADDLE_FUSED_LN=interpret`` routes to the
    wrappers, which run the kernels' plain versions there (where JAX runs
    the Pallas interpreter), so one test drives both packages down the
    same route."""
    mode = os.environ.get("PADDLE_FUSED_LN", "1").strip().lower()
    if mode in ("0", "false", "off"):
        return False
    if weight is None or bias is None or len(normalized_shape) != 1:
        return False
    if x.dim() < 2 or x.dtype not in (torch.float32, torch.bfloat16):
        return False
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    row_floor = 16 if x.dtype == torch.bfloat16 else 8
    if D % 128 != 0 or rows == 0 or rows % row_floor != 0:
        return False
    if not (x.is_cuda or mode == "interpret"):
        return False
    from .attention import shard_route_allowed

    return shard_route_allowed("layer_norm")


def _shape(normalized_shape) -> tuple:
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


def layer_norm(x: torch.Tensor, normalized_shape: Union[int, Sequence[int]],
               weight=None, bias=None, epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes of ``x``."""
    normalized_shape = _shape(normalized_shape)
    if _fused_ln_route(x, normalized_shape, weight, bias):
        return _ln.fused_layer_norm(x, weight, bias, epsilon)
    x, weight, bias = amp.cast_if_amp("layer_norm", (x, weight, bias))
    axes = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def fused_residual_layer_norm(x, residual, normalized_shape, weight=None,
                              bias=None, epsilon: float = 1e-5):
    """(x + residual, LayerNorm(x + residual)) — the pre-LN block seam: one
    B6 kernel when routed, the dense sum then :func:`layer_norm`
    otherwise. Eligibility reads ``x`` and the equal shapes only, as the
    JAX package's does: ``residual`` may be of another type (a bfloat16
    branch under AMP), and ``s`` comes back in ``x``'s type."""
    normalized_shape = _shape(normalized_shape)
    if _fused_ln_route(x, normalized_shape, weight, bias) \
            and x.shape == residual.shape:
        return _ln.fused_add_layer_norm(x, residual, weight, bias, epsilon)
    s = x + residual
    return s, layer_norm(s, normalized_shape, weight, bias, epsilon)


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


def _affine(out, weight, bias, ch):
    shape = [1] * out.dim()
    shape[ch] = out.shape[ch]
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each sample's channels in ``num_groups`` groups (biased
    variance), then the per-channel affine."""
    ch = _channel_axis(x, data_format)
    if x.shape[ch] % num_groups != 0:
        raise ValueError("channels not divisible by num_groups")
    a = torch.movedim(x, ch, 1)
    g = a.reshape(a.shape[0], num_groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = g.var(dim=-1, keepdim=True, correction=0)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(a.shape)
    return torch.movedim(_affine(out, weight, bias, 1), 1, ch)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalize each sample's channels over their spatial axes, then the
    per-channel affine. ``running_mean``, ``running_var``,
    ``use_input_stats`` and ``momentum`` are taken and unused, as in the
    JAX package."""
    ch = _channel_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i not in (0, ch))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    return _affine((x - mean) / torch.sqrt(var + eps), weight, bias, ch)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    n = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum of x^2 over a window of size channels)^beta``;
    the window around channel c runs from ``c - size // 2`` to ``c + (size
    - 1) // 2`` (``alpha`` not divided by ``size``, as in the JAX
    package)."""
    ch = _channel_axis(x, data_format)
    sq = torch.movedim(x * x, ch, 1)
    half = size // 2
    pads = [0, 0] * (sq.dim() - 2) + [half, size - half - 1]
    padded = torch.nn.functional.pad(sq, pads)
    C = sq.shape[1]
    acc = sum(padded.narrow(1, i, C) for i in range(size))
    return x / (k + alpha * torch.movedim(acc, 1, ch)) ** beta
