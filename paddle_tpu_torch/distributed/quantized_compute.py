"""Pre-quantized linear weights for serving (counterpart of
``paddle_tpu/distributed/quantized_compute.py``: the weight layout, the
quantized matmul, the narrow layer form and its byte record).

A linear weight carries an int8/fp8 payload at its own shape and float32
scales per block along the contraction axis. Weights are paddle's ``[in,
out]`` in both packages: the payload is ``[in, out]`` and the scales
``[in/bs, out]``, the JAX package's layout, so both encode the same bytes
and a checkpoint crosses as it is.

:func:`quantized_matmul` widens the payload and multiplies: plain PyTorch,
as the JAX package leaves the product to XLA. Eagerly the widened weight
is written out before the product, so a step reads the narrow payload and
writes and reads the float weight.

Not ported (ROADMAP queue A items 3 and 7): the fake-quant training matmul
(``qat_matmul``) that ``PADDLE_Q_MATMUL`` or
``strategy.quantized_matmul`` arm, and the quantized optimizer moments.
The linear seam raises for them.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from . import quantized_comm as qc

__all__ = [
    "DEFAULT_BLOCK", "SCALE_BUFFER", "matmul_policy", "quantize_weight",
    "dequantize_weight", "quantized_matmul", "iter_quantizable",
    "attach_quantized", "quantize_layer", "q_matmul_info",
]

#: contraction-axis block width
DEFAULT_BLOCK = 128
#: the buffer a narrow weight's scales register under on the owning layer
#: (not persistent: the state dict keeps the weight's own name only)
SCALE_BUFFER = "weight_q_scale"


def matmul_policy():
    """``PADDLE_Q_MATMUL`` -> a resolved (dtype, block) pair or None
    (raises on a typo). The linear seam raises on a policy: its
    fake-quant matmul is not ported."""
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
