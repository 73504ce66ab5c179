"""Common functionals: ``linear`` and ``dropout`` (counterparts of
``paddle_tpu/nn/functional/common.py``).

``linear`` is the one seam every projection of the port goes through
(``Linear`` and the parallel layers), and the AMP cast site of the
white-listed name ``linear``. Its weight is paddle's ``[in, out]``, as in
the JAX package; the product takes it as a transposed operand of the
same GEMM, with no copy. A narrow weight (an int8/fp8 checkpoint, or
``distributed.quantized_compute.quantize_layer``) always takes the
quantized matmul; ``PADDLE_Q_MATMUL`` (the fake-quant training matmul)
raises: not ported.

``dropout`` draws its mask from the ``torch.Generator`` the caller passes,
else from the package's generator of the input's device (``paddle.seed``
seeds it): the port touches no global RNG. Its bits are not JAX's; the
same generator state gives the same mask.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import amp
from ...core.random import default_generator

__all__ = ["linear", "dropout"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``; under AMP the
    float inputs are cast to the AMP type first (white list). A weight
    that carries scales (``quantized_compute.attach_quantized``) is
    widened to ``x``'s type and multiplied (``quantized_matmul``). A wide
    weight under ``PADDLE_Q_MATMUL`` raises ``NotImplementedError``: the
    fake-quant matmul is ROADMAP queue A item 7."""
    from ...distributed import quantized_compute as Q

    qsc = Q.scale_of(weight)
    if qsc is not None:
        x, qsc, bias = amp.cast_if_amp("linear", (x, qsc, bias))
        return Q.quantized_matmul(x, weight, qsc, bias)
    if weight.dim() == 2 and weight.is_floating_point() \
            and Q.matmul_policy() is not None:
        raise NotImplementedError(
            "PADDLE_Q_MATMUL (the fake-quant qat_matmul over a wide weight) "
            "is not ported yet: ROADMAP queue A item 7; unset it, or load "
            "int8/fp8 weights (jit.load_quantized) to serve them narrow")
    x, weight, bias = amp.cast_if_amp("linear", (x, weight, bias))
    return torch.nn.functional.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None):
    """paddle.nn.functional.dropout. ``upscale_in_train`` keeps each
    element with probability ``1 - p`` and divides the kept ones by
    ``1 - p`` in training (identity at inference); ``downscale_in_infer``
    keeps them unscaled in training and multiplies by ``1 - p`` at
    inference. ``axis`` (an int or a list) draws one decision per index
    of those axes, shared along the others. The mask comes from
    ``generator`` (on ``x``'s device), the package's generator of that
    device when None."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        generator = default_generator(x.device)
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in
                (axis if isinstance(axis, (list, tuple)) else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
