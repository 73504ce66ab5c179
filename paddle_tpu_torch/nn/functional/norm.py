"""LayerNorm functionals and their route to the hand-written kernels.

Counterpart of ``paddle_tpu/nn/functional/norm.py``'s ``layer_norm``,
``fused_residual_layer_norm`` and ``_fused_ln_route`` (single device:
the shard_map seam of the JAX package belongs to a later slice). A routed
call goes through the autograd Functions of ``ops/kernels/layer_norm.py``
on both devices, so its backward runs the B7 kernel.

AMP, as in the JAX package: the dense ``layer_norm`` is black-listed
(float32 in, float32 out); the routed forms are on neither list, so the
kernels take their inputs in the type they come in. Under AMP O1 the
pre-LN block's residual seam meets a float32 residual stream ``x`` and a
bfloat16 attention branch: that pair goes to the B6 kernel as it is, which
returns ``s`` and ``LN(s)`` in ``x``'s type.
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import torch

from ... import amp
from ...ops.kernels import layer_norm as _ln

__all__ = ["layer_norm", "fused_residual_layer_norm"]


def _fused_ln_route(x: torch.Tensor, normalized_shape, weight, bias) -> bool:
    """Route this LayerNorm to the B5/B6 kernel wrappers?

    The JAX package's eligibility rule, unchanged: last-axis-only
    normalization with both affine params, float32 or bfloat16, D % 128
    == 0 and rows a multiple of 8 (float32) or 16 (bfloat16).
    ``PADDLE_FUSED_LN=0`` keeps the dense path everywhere. "Backend has
    the kernel" is a CUDA tensor; on the CPU ``PADDLE_FUSED_LN=interpret``
    routes to the wrappers, which run the kernels' plain versions there
    (where JAX runs the Pallas interpreter), so one test drives both
    packages down the same route."""
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
    return x.is_cuda or mode == "interpret"


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
