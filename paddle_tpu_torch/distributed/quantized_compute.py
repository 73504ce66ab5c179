"""Block-scaled compute: pre-quantized linear weights for serving, the
fake-quant training matmul and the narrow optimizer moments (counterpart
of ``paddle_tpu/distributed/quantized_compute.py``: the policy and scope
of its lines 67-101, ``qat_matmul`` and the moment layouts of 145-230,
the byte records of 315-353).

A linear weight carries an int8/fp8 payload at its own shape and float32
scales per block along the contraction axis. Weights are paddle's ``[in,
out]`` in both packages: the payload is ``[in, out]`` and the scales
``[in/bs, out]``, the JAX package's layout, so both encode the same bytes
and a checkpoint crosses as it is.

:func:`quantized_matmul` widens the payload and multiplies: plain PyTorch,
as the JAX package leaves the product to XLA. Eagerly the widened weight
is written out before the product, so a step reads the narrow payload and
writes and reads the float weight.

**Training through the quantizer.** A wide weight under an armed policy
(``strategy.quantized_matmul`` through ``jit.TrainStep``'s
:func:`matmul_scope`, or ``PADDLE_Q_MATMUL``) takes :func:`qat_matmul`
at the linear seam: the forward multiplies by the block-quantized weight,
the backward is straight-through (``dx`` through the same dequantized
weight, ``dw`` at full width in float32 onto the wide master). The
optimizer moments of ``quantize_moments`` (``optimizer.Adam``/``AdamW``)
are held narrow in the KV cache's last-axis block layout:
:func:`moment_narrow` / :func:`moment_wide`, and for the second moment
:func:`moment2_narrow` / :func:`moment2_wide`, which quantize ``sqrt(v)``.
All of it is plain PyTorch: the JAX package computes it with ``jnp``
outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch import nn

from . import quantized_comm as qc

__all__ = [
    "DEFAULT_BLOCK", "SCALE_BUFFER", "resolve_matmul", "matmul_policy",
    "matmul_scope", "quantize_weight", "dequantize_weight",
    "quantized_matmul", "qat_matmul", "moment_narrow", "moment_wide",
    "moment2_narrow", "moment2_wide", "iter_quantizable",
    "attach_quantized", "quantize_layer", "q_matmul_info",
    "moment_bytes_info",
]

#: contraction-axis block width
DEFAULT_BLOCK = 128
#: the buffer a narrow weight's scales register under on the owning layer
#: (not persistent: the state dict keeps the weight's own name only)
SCALE_BUFFER = "weight_q_scale"


def resolve_matmul(value, block=DEFAULT_BLOCK):
    """``strategy.quantized_matmul`` -> ("int8" | "fp8", block) or None;
    raises on a typo and on fp8 where torch lacks the type."""
    return qc.resolve_policy(value, block, knob="quantized_matmul")


#: the policies of the open :func:`matmul_scope` blocks, innermost last
_SCOPE = []


@contextlib.contextmanager
def matmul_scope(policy):
    """Arm (or, with None, force off) the quantized-matmul route for the
    block's extent; ``policy`` is a resolved (dtype, block) pair."""
    _SCOPE.append(policy)
    try:
        yield
    finally:
        _SCOPE.pop()


def matmul_policy():
    """The policy the linear seam reads on each call: the innermost
    :func:`matmul_scope`'s, else ``PADDLE_Q_MATMUL`` (raises on a typo),
    else None."""
    if _SCOPE:
        return _SCOPE[-1]
    env = os.environ.get("PADDLE_Q_MATMUL", "").strip().lower()
    if not env or env in ("0", "off", "false", "none"):
        return None
    return qc.resolve_policy(env, knob="PADDLE_Q_MATMUL")


def quantize_weight(w, dtype: str = "int8", block: int = DEFAULT_BLOCK):
    """``w [in, out]`` -> (payload ``[in, out]`` narrow, scales ``[in/bs,
    out]`` float32): one scale per ``bs`` inputs of one output, ``bs``
    the whole input axis when ``block`` does not tile it."""
    return qc.quantize_along(w, dtype, block, axis=0)


def dequantize_weight(payload, scales, out_dtype=torch.float32):
    """The inverse of :func:`quantize_weight`: the wide ``[in, out]``
    weight at ``out_dtype``."""
    return qc.dequantize_along(payload, scales, out_dtype, axis=0)


def quantized_matmul(x, w_q, scales, bias=None):
    """``x [..., in] @ dequant(w_q, scales) + bias``, the weight widened
    to ``x``'s type."""
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    return torch.nn.functional.linear(
        x, dequantize_weight(w_q, scales, out_dtype).t(), bias)


class _QatMatmul(torch.autograd.Function):
    """``x @ dequant(quant(w))`` with the straight-through backward."""

    @staticmethod
    def forward(ctx, x, w, dtype, block):
        wq, ws = quantize_weight(w.detach(), dtype, block)
        wdq = dequantize_weight(wq, ws, w.dtype)
        ctx.save_for_backward(x, wdq)
        return torch.matmul(x, wdq)

    @staticmethod
    def backward(ctx, g):
        x, wdq = ctx.saved_tensors
        dx = torch.matmul(g, wdq.t()).to(x.dtype)
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        gf = g.reshape(-1, g.shape[-1]).to(torch.float32)
        dw = torch.matmul(xf.t(), gf).to(wdq.dtype)
        return dx, dw, None, None


def qat_matmul(x, w, dtype: str = "int8", block: int = DEFAULT_BLOCK):
    """Fake-quant matmul over a wide weight ``w [in, out]``: the forward
    multiplies by the block-quantized weight (what a narrow deployment
    runs), the backward is straight-through: ``dx`` through the same
    dequantized weight, ``dw = x^T g`` in float32, cast to ``w``'s type,
    so the optimizer keeps accumulating updates smaller than one
    quantization step."""
    return _QatMatmul.apply(x, w, dtype, block)


def moment_narrow(m, dtype: str = "int8", block: int = DEFAULT_BLOCK):
    """A float moment -> (payload, scales) in the last-axis block layout.
    A 0-d moment stays wide: the payload is its float32 value and the
    scale a 0-d zero sentinel that :func:`moment_wide` recognises."""
    if m.dim() == 0:
        return m.to(torch.float32), torch.zeros((), dtype=torch.float32,
                                                device=m.device)
    return qc.quantize_lastaxis(m, dtype, block)


def moment_wide(payload, scales, out_dtype=torch.float32):
    """The inverse of :func:`moment_narrow`."""
    if payload.dim() == 0 or scales.dim() == 0:
        return payload.to(out_dtype)
    return qc.dequantize_lastaxis(payload, scales, out_dtype)


def moment2_narrow(v, dtype: str = "int8", block: int = DEFAULT_BLOCK):
    """The second moment narrow: ``sqrt(v)`` is quantized, not ``v``. On
    ``v`` (which scales as ``g**2``) an element 16x below its block's
    largest already rounds to a zero payload while the first moment's
    element survives, and ``m / (sqrt(0) + eps)`` grows by ``1/eps``; in
    the sqrt domain both moments scale as ``g``."""
    return moment_narrow(torch.sqrt(torch.clamp(v, min=0.0)), dtype, block)


def moment2_wide(payload, scales, out_dtype=torch.float32):
    """The inverse of :func:`moment2_narrow`, with a half-step floor: an
    element whose ``sqrt(v)`` rounded to a zero payload had a true value in
    ``[0, scale/2)`` and comes back as ``scale/2``, within half a step of
    the truth, with no ``1/eps`` blow-up. A block of zero scale (a moment
    never touched) stays exactly zero."""
    if payload.dim() == 0 or scales.dim() == 0:
        u = payload.to(torch.float32)
        return (u * u).to(out_dtype)
    d, nb = int(payload.shape[-1]), int(scales.shape[-1])
    sc = scales[..., None].to(torch.float32)
    pr = payload.reshape(tuple(payload.shape[:-1]) + (nb, d // nb))
    ur = qc._widen(pr, sc)
    ur = torch.maximum(ur, 0.5 * sc)
    u = ur.reshape(payload.shape)
    return (u * u).to(out_dtype)


def _linear_classes():
    from ..nn.layers.common import Linear

    return (Linear,)  # the parallel linears subclass it


def iter_quantizable(layer):
    """(param name, sublayer, weight) of every matmul weight the narrow
    form covers: the 2-D ``weight`` of each ``Linear`` (the parallel
    linears and attention projections included). Embeddings and norms
    stay wide."""
    classes = _linear_classes()
    for lname, sub in layer.named_modules():
        if not isinstance(sub, classes):
            continue
        w = sub._parameters.get("weight")
        if w is None or w.dim() != 2:
            continue
        if not w.is_floating_point() and scale_of(w) is None:
            continue
        yield (f"{lname}.weight" if lname else "weight"), sub, w


def scale_of(weight):
    """The scales of a narrow weight, or None for a wide one."""
    return getattr(weight, "_q_scale", None)


def attach_quantized(sub, payload, scales):
    """Install a narrow (payload, scales) pair as ``sub``'s weight, in
    place: the parameter keeps its name and holds the payload (no
    gradient), the scales ride the non-persistent ``weight_q_scale``
    buffer, and ``functional.linear`` routes the weight through
    :func:`quantized_matmul` from then on. Returns the scales."""
    w = nn.Parameter(payload, requires_grad=False)
    sub.weight = w
    sub.register_buffer(SCALE_BUFFER, scales, persistent=False)
    w._q_scale = scales
    return scales


def quantize_layer(layer, dtype: str = "int8", block: int = DEFAULT_BLOCK):
    """Narrow every eligible linear weight of ``layer`` in place and
    return the byte record ``{"dtype", "block", "quantized": [names],
    "bytes_payload", "bytes_scales", "bytes_wide_f32"}``. Weights already
    narrow are skipped."""
    pol = qc.resolve_policy(dtype, block, knob="quantized_matmul")
    if pol is None:
        raise ValueError("quantize_layer needs an explicit 'int8'/'fp8'")
    dt, bs = pol
    names, b_payload, b_scales, b_wide = [], 0, 0, 0
    for pname, sub, w in list(iter_quantizable(layer)):
        if scale_of(w) is not None:
            continue
        payload, scales = quantize_weight(w.detach(), dt, bs)
        attach_quantized(sub, payload, scales)
        names.append(pname)
        b_payload += payload.numel()
        b_scales += 4 * scales.numel()
        b_wide += 4 * payload.numel()
    return {"dtype": dt, "block": bs, "quantized": names,
            "bytes_payload": int(b_payload), "bytes_scales": int(b_scales),
            "bytes_wide_f32": int(b_wide)}


def q_matmul_info(n_elems: int, policy) -> dict:
    """The static ``q_matmul`` record: resident matmul-weight bytes under
    ``policy`` (a resolved pair, or None) beside the bf16 baseline."""
    n = int(n_elems)
    if policy is not None:
        dtype, block = policy
        resident = qc.wire_bytes(n, dtype, block)
    else:
        dtype, block = "bfloat16", 0
        resident = 2 * n
    bf16 = 2 * n
    return {"dtype": dtype, "block": int(block), "weight_elems": n,
            "bytes_resident": int(resident), "bytes_bf16": int(bf16),
            "reduction_x": round(bf16 / resident, 2) if resident else 1.0}


def moment_bytes_info(n_elems: int, policy) -> dict:
    """The static ``moment_bytes`` record: the resident bytes of the two
    Adam moments of ``n_elems`` values under ``policy`` (a resolved pair,
    or None) beside float32: each moment one byte a value plus a float32
    scale per ``block`` values, counted on the flat total, which equals
    the per-row count when every trailing axis is a multiple of the
    block."""
    n = int(n_elems)
    if policy is not None:
        dtype, block = policy
        per_moment = qc.wire_bytes(n, dtype, block)
    else:
        dtype, block = "float32", 0
        per_moment = 4 * n
    f32 = 8 * n
    resident = 2 * per_moment
    return {"dtype": dtype, "block": int(block), "moment_elems": n,
            "bytes_resident": int(resident), "bytes_f32": int(f32),
            "reduction_x": round(f32 / resident, 2) if resident else 1.0}
