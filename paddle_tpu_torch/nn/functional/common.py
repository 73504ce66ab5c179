"""Common functionals (counterparts of ``paddle_tpu/nn/functional/common.py``):
``linear``, the dropouts, ``embedding``, ``one_hot``, ``interpolate``,
``cosine_similarity``, ``pixel_shuffle``, ``unfold``, ``label_smooth``,
``bilinear`` and ``class_center_sample``; ``pad`` is the op namespace's
(``ops/manipulation.py``), re-exported by ``nn.functional``.

``linear`` is the one seam every projection of the port goes through
(``Linear`` and the parallel layers), and the AMP cast site of the
white-listed name ``linear``. Its weight is paddle's ``[in, out]``, as in
the JAX package; the product takes it as a transposed operand of the
same GEMM, with no copy. A narrow weight (an int8/fp8 checkpoint, or
``distributed.quantized_compute.quantize_layer``) always takes the
quantized matmul; a wide 2-D float weight under an armed policy
(``strategy.quantized_matmul`` through ``TrainStep``'s scope, or
``PADDLE_Q_MATMUL``) takes the fake-quant ``qat_matmul``.

``dropout`` (and ``dropout2d``/``dropout3d``, ``alpha_dropout``,
``class_center_sample``) draws from the ``torch.Generator`` the caller
passes, else from the package's generator of the input's device
(``paddle.seed`` seeds it): the port touches no global RNG. Its bits are
not JAX's; the same generator state gives the same mask.

``interpolate`` computes what the JAX package computes, which is
``jax.image.resize`` and not upstream Paddle's rule: half-pixel sample
positions, "nearest" at ``floor((i + 0.5) * in / out)``, the linear modes
(and "area") with a triangle filter that widens when downsampling
(antialiasing), "bicubic" with the Keys kernel (a = -0.5), edge weights
renormalised. ``align_corners`` and ``align_mode`` are taken and have no
effect, as in the JAX package; a named departure from upstream Paddle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import amp
from ...core import random as rnd
from ...core.random import default_generator

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "interpolate", "upsample", "cosine_similarity",
    "pixel_shuffle", "unfold", "label_smooth", "bilinear",
    "class_center_sample",
]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]``; under AMP the
    float inputs are cast to the AMP type first (white list). A weight
    that carries scales (``quantized_compute.attach_quantized``) is
    widened to ``x``'s type and multiplied (``quantized_matmul``). A wide
    2-D float weight under an armed policy (``quantized_compute.
    matmul_policy()``) goes through ``qat_matmul``, after the AMP cast."""
    from ...distributed import quantized_compute as Q

    qsc = Q.scale_of(weight)
    if qsc is not None:
        x, qsc, bias = amp.cast_if_amp("linear", (x, qsc, bias))
        return Q.quantized_matmul(x, weight, qsc, bias)
    pol = Q.matmul_policy() if weight.dim() == 2 \
        and weight.is_floating_point() else None
    x, weight, bias = amp.cast_if_amp("linear", (x, weight, bias))
    if pol is not None:
        out = Q.qat_matmul(x, weight, *pol)
        return out if bias is None else out + bias
    return torch.nn.functional.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None,
            stream: str = "dropout"):
    """paddle.nn.functional.dropout. ``upscale_in_train`` keeps each
    element with probability ``1 - p`` and divides the kept ones by
    ``1 - p`` in training (identity at inference); ``downscale_in_infer``
    keeps them unscaled in training and multiplies by ``1 - p`` at
    inference. ``axis`` (an int or a list) draws one decision per index
    of those axes, shared along the others. The mask comes from
    ``generator`` (on ``x``'s device); when None, the package's generator
    of that device, or in a job of several ranks this rank's named
    ``stream`` (``core.random``: "dropout" per dp rank, "dropout_mp" per
    dp and mp rank)."""
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
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in
                (axis if isinstance(axis, (list, tuple)) else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = rnd.rand(shape, generator=generator, device=x.device,
                    stream=stream) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    """Whole channels dropped: one decision per (sample, channel)."""
    ch = 1 if data_format == "NCHW" else 3
    return dropout(x, p, axis=[0, ch], training=training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    ch = 1 if data_format == "NCDHW" else 4
    return dropout(x, p, axis=[0, ch], training=training,
                   generator=generator)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, *,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: a dropped element becomes ``-alpha *
    scale``, then ``a * out + b`` with the JAX package's coefficients, so
    the mean and variance stay."""
    if not training or p == 0.0:
        return x
    keep = rnd.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device)) + b


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; where an id equals
    ``padding_idx`` the row is zeros and sends no gradient. As in the JAX
    package the id is compared as given: a negative ``padding_idx``
    matches no id (the layer ``Embedding`` takes it modulo the table's
    rows). ``sparse`` is taken and the gradient is dense, as there."""
    ids = x.long()
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows of ``num_classes``; an id outside ``[0,
    num_classes)`` gives a row of zeros (``jax.nn.one_hot``)."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """``[n_in, n_out]`` float32 weights of one axis
    (``jax.image.resize``'s ``compute_weight_mat``, translation 0,
    antialiasing on)."""
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) \
        * inv - 0.5
    dist = (sample[None, :] - torch.arange(
        n_in, device=device, dtype=torch.float32)[:, None]).abs() \
        / max(inv, 1.0)
    w = kernel(dist)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of ``x`` (after N and C for ``NC...``,
    else between N and the channels) to ``size``, or to ``int(in *
    scale_factor)``, by ``mode``: nearest, linear, bilinear, trilinear,
    bicubic or area (the module's notes say which function)."""
    kernels = {"bilinear": _triangle, "linear": _triangle,
               "trilinear": _triangle, "area": _triangle,
               "bicubic": _keys_cubic, "nearest": None}
    if mode not in kernels:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    n_sp = x.dim() - 2
    first = 2 if data_format.startswith("NC") else 1
    axes = list(range(first, first + n_sp))
    in_sp = [int(x.shape[a]) for a in axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sp = [int(s) for s in (size if isinstance(size, (list, tuple))
                                   else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * n_sp
        out_sp = [int(d * f) for d, f in zip(in_sp, sf)]
    for a, m, n in zip(axes, in_sp, out_sp):
        if m == n:
            continue
        if kernels[mode] is None:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * (m / n)).long().to(x.device)
            x = x.index_select(a, idx)
            continue
        w = _resize_weights(m, n, kernels[mode], x.device).to(x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, a, -1), w), -1, a)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 x2) / max(|x1| |x2|, eps)`` over ``axis``."""
    num = (x1 * x2).sum(dim=axis)
    den = torch.linalg.vector_norm(x1, dim=axis) \
        * torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def _two(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of ``[N, C, H, W]`` -> ``[N, C kh kw, L]``. As in the JAX
    package, ``paddings`` gives the top/bottom pad in its first value and
    the left/right pad in its second."""
    k, s, p, d = (_two(v) for v in (kernel_sizes, strides, paddings,
                                    dilations))
    return torch.nn.functional.unfold(x, k[:2], d[:2], p[:2], s[:2])


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) label + epsilon prior_dist``, the prior uniform
    (``1 / C``) when None."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] + bias[o]``, ``W`` ``[out, in1,
    in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def class_center_sample(label, num_classes, num_samples, group=None, *,
                        generator: Optional[torch.Generator] = None):
    """Sample ``num_samples`` class centres that include every class in
    ``label`` -> ``(remapped_label, sampled_class_center)``: the classes
    present, ascending, then negatives drawn without replacement from the
    rest (``generator``, the package's when None), ascending; each label
    is remapped to its class's index in the sample. The JAX package
    raises here (not implemented): this is upstream Paddle's function, a
    named departure, and so is its refusal of ``group`` (upstream's
    model-parallel split), which has no counterpart in the JAX package
    to port and must be None."""
    if group is not None:
        raise NotImplementedError("class_center_sample(group=): the "
                                  "model-parallel split is a departure "
                                  "the port does not take (the JAX "
                                  "package raises for the whole function)")
    if generator is None:
        generator = default_generator(label.device)
    flat = label.reshape(-1).long()
    pos = torch.unique(flat)
    n_neg = max(int(num_samples) - int(pos.numel()), 0)
    if n_neg:
        rest = torch.ones(int(num_classes), dtype=torch.bool,
                          device=label.device)
        rest[pos] = False
        cand = torch.nonzero(rest).reshape(-1)
        pick = torch.randperm(int(cand.numel()), generator=generator,
                              device=label.device)[:n_neg]
        sampled = torch.cat([pos, torch.sort(cand[pick]).values])
    else:
        sampled = pos
    remap = torch.full((int(num_classes),), -1, dtype=torch.int64,
                       device=label.device)
    remap[sampled] = torch.arange(sampled.numel(), device=label.device)
    return remap[flat].reshape(label.shape), sampled
