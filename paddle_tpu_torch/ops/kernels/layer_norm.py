"""Row LayerNorm forward (B5) and residual-add + LayerNorm forward (B6).

The port of ``paddle_tpu/ops/pallas/layer_norm.py``'s ``_ln_fwd_kernel``
and ``_add_ln_fwd_kernel``: a hand-written CUDA kernel for Hopper
(``csrc/layer_norm.cu``), its plain PyTorch version, and a launch count
per wrapper.

What bounds the kernels on the H100 is bytes, not flops (a few flops per
element moved); the CUDA source says what its design does about it. Stats
are f32 whatever the input type; the output keeps the input type; mean and
rstd come back as ``[R]`` f32 (the TPU's ``(R, 128)`` lane-broadcast is a
TPU layout, not part of the function).

Layout contract, as in the JAX package: ``x`` is ``[..., D]`` with the
normalized axis last; ``weight``/``bias`` are ``[D]``. The router in
``nn/functional/norm.py`` only sends shapes the Pallas kernel accepts
(rows % 8 for f32, % 16 for bf16; D % 128).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "add_ln_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
}
SOURCE = "paddle_tpu_torch/csrc/layer_norm.cu"


def _stats(x32: torch.Tensor, eps: float):
    mu = x32.mean(dim=-1)
    xc = x32 - mu[:, None]
    var = (xc * xc).mean(dim=-1)
    rs = torch.rsqrt(var + eps)
    return xc, mu, rs


def layer_norm_fwd_plain(x2d, weight, bias, eps=1e-5):
    """Plain PyTorch version of the B5 kernel: ``[R, D]`` -> (y in x's
    type, mean [R] f32, rstd [R] f32)."""
    xc, mu, rs = _stats(x2d.float(), eps)
    y = xc * rs[:, None] * weight.float() + bias.float()
    return y.to(x2d.dtype), mu, rs


def add_layer_norm_fwd_plain(x2d, y2d, weight, bias, eps=1e-5):
    """Plain PyTorch version of the B6 kernel: s = x + y stored in x's
    type, then LayerNorm of the STORED s. Returns (s, LN(s), mean,
    rstd)."""
    s = (x2d.float() + y2d.float()).to(x2d.dtype)
    out, mu, rs = layer_norm_fwd_plain(s, weight, bias, eps)
    return s, out, mu, rs


def _check(what, x2d, weight, bias, *more):
    if x2d.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x2d.dtype} not supported "
                        "(float32, bfloat16)")
    for t in more:
        if t.dtype != x2d.dtype or t.shape != x2d.shape:
            raise ValueError(f"{what}: addends must match in shape and type")
    if x2d.dim() != 2 or weight.shape != (x2d.shape[1],) \
            or bias.shape != (x2d.shape[1],):
        raise ValueError(f"{what}: x must be [R, D] with weight/bias [D]")
    return _build.require_cuda(what, x2d, weight, bias, *more)


def layer_norm_fwd(x2d, weight, bias, eps=1e-5):
    """LayerNorm forward of ``[R, D]`` rows -> (y, mean [R], rstd [R])."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_plain(x2d, weight, bias, eps)
    dev = _check("layer_norm_fwd", x2d, weight, bias)
    R, D = x2d.shape
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    y = torch.empty_like(x2d)
    mu = torch.empty(R, device=dev, dtype=torch.float32)
    rs = torch.empty(R, device=dev, dtype=torch.float32)
    lib = _build.library("layer_norm", _SIGNATURES)
    rc = lib.ln_fwd(x2d.data_ptr(), w.data_ptr(), b.data_ptr(),
                    y.data_ptr(), mu.data_ptr(), rs.data_ptr(), R, D,
                    float(eps), _build.DTYPE_CODE[x2d.dtype],
                    _build.stream_ptr(dev))
    _build.check(rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mu, rs


def add_layer_norm_fwd(x2d, y2d, weight, bias, eps=1e-5):
    """(s = x + y, LN(s), mean [R], rstd [R]) of ``[R, D]`` rows in one
    pass."""
    if x2d.device.type == "cpu":
        return add_layer_norm_fwd_plain(x2d, y2d, weight, bias, eps)
    dev = _check("add_layer_norm_fwd", x2d, weight, bias, y2d)
    R, D = x2d.shape
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    s = torch.empty_like(x2d)
    out = torch.empty_like(x2d)
    mu = torch.empty(R, device=dev, dtype=torch.float32)
    rs = torch.empty(R, device=dev, dtype=torch.float32)
    lib = _build.library("layer_norm", _SIGNATURES)
    rc = lib.add_ln_fwd(x2d.data_ptr(), y2d.data_ptr(), w.data_ptr(),
                        b.data_ptr(), s.data_ptr(), out.data_ptr(),
                        mu.data_ptr(), rs.data_ptr(), R, D, float(eps),
                        _build.DTYPE_CODE[x2d.dtype], _build.stream_ptr(dev))
    _build.check(rc, "add_layer_norm_fwd")
    add_layer_norm_fwd.launches += 1
    return s, out, mu, rs


layer_norm_fwd.launches = 0
add_layer_norm_fwd.launches = 0


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis of ``x`` ([..., D]) through the B5
    kernel; the counterpart of ``paddle_tpu``'s ``fused_layer_norm``."""
    D = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, D).contiguous(), weight, bias,
                             eps)
    return y.reshape(x.shape)


def fused_add_layer_norm(x, y, weight, bias, eps=1e-5):
    """(x + y, LayerNorm(x + y)) through the B6 kernel; the counterpart of
    ``paddle_tpu``'s ``fused_add_layer_norm``."""
    D = x.shape[-1]
    s, out, _, _ = add_layer_norm_fwd(
        x.reshape(-1, D).contiguous(), y.reshape(-1, D).contiguous(),
        weight, bias, eps)
    return s.reshape(x.shape), out.reshape(x.shape)
