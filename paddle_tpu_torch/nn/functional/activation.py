"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``), on ``torch.Tensor``.

Paddle's defaults, which are not always torch's: ``hardsigmoid`` is
``clip(x * 0.1666667 + 0.5, 0, 1)``, ``leaky_relu``'s slope 0.01,
``thresholded_relu``'s threshold 1.0, ``softplus(beta, threshold)`` the
identity where ``x * beta > threshold``. ``softmax`` and ``log_softmax``
cast to ``dtype`` before the op and are black-listed for AMP (float32 in).
``sigmoid`` and ``tanh`` of ``nn.functional`` are the op namespace's
(``ops/math.py``); this module has none of its own.

``gumbel_softmax`` draws its noise from ``generator`` (the package's
generator of the input's device when None): its values are not JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import amp
from ...core.dtype import convert_dtype
from ...core import random as rnd

__all__ = [
    "relu", "relu6", "gelu", "softmax", "log_softmax", "leaky_relu", "elu",
    "selu", "celu", "silu", "swish", "mish", "softplus", "softsign",
    "hardtanh", "hardsigmoid", "hardswish", "hardshrink", "softshrink",
    "tanhshrink", "thresholded_relu", "log_sigmoid", "maxout", "prelu",
    "glu", "gumbel_softmax", "softmax_with_cross_entropy",
]

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def gelu(x: torch.Tensor, approximate=False, name=None) -> torch.Tensor:
    """GELU, the exact erf form by default (paddle's), the tanh form with
    ``approximate``. On neither AMP list: a bfloat16 input gives a
    bfloat16 output."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor, name=None) -> torch.Tensor:
    """max(x, 0) in x's type; on neither AMP list."""
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def silu(x, name=None):
    return torch.nn.functional.silu(x)


def swish(x, name=None):
    return silu(x)


def softsign(x, name=None):
    return x / (1 + x.abs())


def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def _cast(x, dtype):
    d = convert_dtype(dtype) if dtype else None
    return x.to(d) if d is not None else x


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``, after a cast to ``dtype`` when given."""
    (x,) = amp.cast_if_amp("softmax", (x,))
    return torch.softmax(_cast(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """log(softmax) over ``axis``, after a cast to ``dtype`` when given."""
    (x,) = amp.cast_if_amp("log_softmax", (x,))
    return torch.log_softmax(_cast(x, dtype), dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.nn.functional.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0, name=None):
    return torch.nn.functional.elu(x, alpha)


def selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return torch.nn.functional.celu(x, alpha)


def mish(x, name=None):
    return x * torch.tanh(torch.nn.functional.softplus(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``x * beta > threshold``, else ``log(1 + exp(beta x)) /
    beta``."""
    return torch.where(x * beta > threshold, x,
                       torch.nn.functional.softplus(x * beta) / beta)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def maxout(x, groups, axis=1, name=None):
    """Max over ``groups`` consecutive groups of ``axis``: the channel
    ``c`` of ``C`` splits into ``(groups, C // groups)`` and the max runs
    over the first, as in the JAX package."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one slope, or one per
    channel (axis 1 for ``NC...``, the last otherwise)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
        weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def glu(x, axis=-1, name=None):
    u, v = torch.chunk(x, 2, dim=axis)
    return u * torch.sigmoid(v)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator: Optional[torch.Generator] = None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g = -log(
    -log(u + 1e-20) + 1e-20)``, ``u`` uniform from ``generator``. With
    ``hard``, the forward is the one-hot of the argmax and the gradient
    the soft sample's (straight through)."""
    u = rnd.rand(x.shape, generator=generator, device=x.device,
                 dtype=x.dtype)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    idx = y.argmax(dim=axis, keepdim=True)
    y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
    return (y_hard - y).detach() + y


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False,
                               numeric_stable_mode=True):
    """The per-row cross entropy with its ``axis`` kept (``[N, 1]`` for
    ``[N, C]`` logits), and the softmax too with ``return_softmax``."""
    from .loss import cross_entropy

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, axis=axis,
                         reduction="none").unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss
