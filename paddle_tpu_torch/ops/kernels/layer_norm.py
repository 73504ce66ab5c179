"""Row LayerNorm forward (B5), residual-add + LayerNorm forward (B6),
LayerNorm backward (B7), and the autograd Functions that join them.

The port of ``paddle_tpu/ops/pallas/layer_norm.py``'s ``_ln_fwd_kernel``,
``_add_ln_fwd_kernel`` and ``_ln_bwd_kernel``: hand-written CUDA kernels
for Hopper (``csrc/layer_norm.cu``), each with its plain PyTorch version
and a launch count per wrapper. The forward ops' autograd formulas are
the counterparts of the ``fused_layer_norm`` / ``fused_add_layer_norm``
custom_vjps: they save what ``_fln_fwd`` / ``_fadd_ln_fwd`` save, ``(x2d
or s2d, weight, mu, rstd)``.

What bounds the kernels on the H100 is bytes, not flops (a few flops per
element moved); the CUDA source says what its design does about it. Stats
are f32 whatever the input type; outputs keep the input type; mean and
rstd come back as ``[R]`` f32 (the TPU's ``(R, 128)`` lane-broadcast is a
TPU layout, not part of the function). The backward kernel writes
per-block dgamma/dbeta partials, which a second kernel sums in a fixed
order (``_ln_backward`` sums the TPU kernel's partials outside it).

Layout contract, as in the JAX package: ``x`` is ``[..., D]`` with the
normalized axis last; ``weight``/``bias`` are ``[D]``. The router in
``nn/functional/norm.py`` only sends shapes the Pallas kernel accepts
(rows % 8 for f32, % 16 for bf16; D % 128).

Each kernel is a ``torch.library`` custom op,
``torch.ops.paddle_tpu_torch.{layer_norm_fwd,add_layer_norm_fwd,
layer_norm_bwd}``, with a fake implementation and, on the two forwards,
an autograd formula that runs ``layer_norm_bwd``. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises. A
wrapper function called directly with an input that requires grad while
grad mode is on raises on either device (its outputs would be cut from
the graph): training goes through the callers of the forward ops,
:class:`LayerNormFunction` and :class:`AddLayerNormFunction`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._build import upcast as _up

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "ln_fwd_path": [_P, _P, _P, _P, _I, _I],
    "add_ln_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "ln_bwd": [_P] * 10 + [_I, _I, _I, _I, _I, _P],
    "ln_bwd_blocks": [_I, _I, _I],
}
SOURCE = "paddle_tpu_torch/csrc/layer_norm.cu"
_FUNCTIONS = ("ops.kernels.layer_norm.LayerNormFunction or "
              "AddLayerNormFunction")


def _stats(x32: torch.Tensor, eps: float):
    mu = x32.mean(dim=-1)
    xc = x32 - mu[:, None]
    var = (xc * xc).mean(dim=-1)
    rs = torch.rsqrt(var + eps)
    return xc, mu, rs


def layer_norm_fwd_plain(x2d, weight, bias, eps=1e-5):
    """Plain PyTorch version of the B5 kernel: ``[R, D]`` -> (y in x's
    type, mean [R], rstd [R], both in the compute type: f32)."""
    xc, mu, rs = _stats(_up(x2d), eps)
    y = xc * rs[:, None] * _up(weight) + _up(bias)
    return y.to(x2d.dtype), mu, rs


def add_layer_norm_fwd_plain(x2d, y2d, weight, bias, eps=1e-5):
    """Plain PyTorch version of the B6 kernel: s = x + y, each addend
    taken to f32, stored in x's type, then LayerNorm of the STORED s.
    Returns (s, LN(s) in x's type, mean, rstd)."""
    s = (_up(x2d) + _up(y2d)).to(x2d.dtype)
    out, mu, rs = layer_norm_fwd_plain(s, weight, bias, eps)
    return s, out, mu, rs


#: types of x the kernels take (the router sends no other: float16 rows
#: take the dense LayerNorm, as in the JAX package)
LN_TYPES = (torch.float32, torch.bfloat16)
#: (x, y) types the add-LN kernel takes: one type, or AMP O1's float32
#: residual stream with a bfloat16 or float16 branch
ADD_LN_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16),
                (torch.float32, torch.float16))


def _check(what, x2d, weight, bias, *more):
    if x2d.dtype not in LN_TYPES:
        raise TypeError(f"{what}: dtype {x2d.dtype} not supported "
                        "(float32, bfloat16)")
    for t in more:
        if t.shape != x2d.shape:
            raise ValueError(f"{what}: operands must match in shape")
        if (x2d.dtype, t.dtype) not in ADD_LN_PAIRS:
            raise ValueError(f"{what}: no kernel for the types "
                             f"({x2d.dtype}, {t.dtype})")
    if x2d.dim() != 2 or weight.shape != (x2d.shape[1],) \
            or bias.shape != (x2d.shape[1],):
        raise ValueError(f"{what}: x must be [R, D] with weight/bias [D]")
    return _build.require_cuda(what, x2d, weight, bias, *more)


def layer_norm_fwd(x2d, weight, bias, eps=1e-5):
    """LayerNorm forward of ``[R, D]`` rows -> (y, mean [R], rstd [R]).
    The kernel takes its register path or its looped path as
    :func:`layer_norm_fwd_path` says."""
    _build.refuse_grad("layer_norm_fwd", _FUNCTIONS, x2d, weight, bias)
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
    _build.count_launch(layer_norm_fwd, x2d)
    return y, mu, rs


def layer_norm_fwd_path(x2d, weight, bias):
    """The path :func:`layer_norm_fwd` takes on these CUDA tensors: kN > 0
    for the register path (D = 128 kN; kN in 1..8 or 16, with ``x2d``
    aligned for 4-element loads), 0 for the looped path. The output the
    wrapper allocates is always aligned."""
    _check("layer_norm_fwd_path", x2d, weight, bias)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    lib = _build.library("layer_norm", _SIGNATURES)
    return lib.ln_fwd_path(x2d.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                           x2d.shape[1], _build.DTYPE_CODE[x2d.dtype])


def add_layer_norm_fwd(x2d, y2d, weight, bias, eps=1e-5):
    """(s = x + y, LN(s), mean [R], rstd [R]) of ``[R, D]`` rows in one
    pass; s and LN(s) in x's type. The addends' types are a pair of
    ``ADD_LN_PAIRS``; any other pair raises on the card."""
    _build.refuse_grad("add_layer_norm_fwd", _FUNCTIONS, x2d, y2d, weight,
                       bias)
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
                        _build.DTYPE_CODE[x2d.dtype],
                        _build.DTYPE_CODE[y2d.dtype], _build.stream_ptr(dev))
    _build.check(rc, "add_layer_norm_fwd")
    _build.count_launch(add_layer_norm_fwd, x2d, y2d)
    return s, out, mu, rs


layer_norm_fwd.launches = 0
layer_norm_fwd.by_dtype = {}
layer_norm_fwd.shapes = set()
add_layer_norm_fwd.launches = 0
add_layer_norm_fwd.by_dtype = {}
add_layer_norm_fwd.shapes = set()


def layer_norm_bwd_plain(x2d, weight, mu, rstd, g2d):
    """Plain PyTorch version of the B7 backward, written from the Pallas
    kernel's formula (not from autograd): with ``x_hat`` recomputed from
    the saved (mu, rstd) and ``g_hat = g * w``, ``dx = rstd * (g_hat -
    mean(g_hat) - x_hat * mean(g_hat * x_hat))``, ``dweight = sum(g *
    x_hat)``, ``dbias = sum(g)``. Returns (dx in x's type, dweight and
    dbias in weight's type)."""
    x, g, w = _up(x2d), _up(g2d), _up(weight)
    xhat = (x - _up(mu)[:, None]) * _up(rstd)[:, None]
    dxhat = g * w
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = _up(rstd)[:, None] * (dxhat - m1 - xhat * m2)
    return (dx.to(x2d.dtype), (g * xhat).sum(dim=0).to(weight.dtype),
            g.sum(dim=0).to(weight.dtype))


def layer_norm_bwd(x2d, weight, mu, rstd, g2d):
    """LayerNorm backward of ``[R, D]`` rows -> (dx in x's type, dweight,
    dbias in weight's type). ``g2d`` is the output cotangent in x's type;
    ``mu``/``rstd`` are the forward's ``[R]`` f32 statistics. The kernel
    writes one f32 row of dweight/dbias partials per thread block into
    scratch, and a second kernel of the same source sums them in a fixed
    order."""
    _build.refuse_grad("layer_norm_bwd", _FUNCTIONS, x2d, weight, g2d)
    if x2d.device.type == "cpu":
        return layer_norm_bwd_plain(x2d, weight, mu, rstd, g2d)
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype:
        raise ValueError("layer_norm_bwd: g must match x in shape and type")
    R, D = x2d.shape
    for t in (mu, rstd):
        if t.shape != (R,) or t.dtype != torch.float32:
            raise ValueError("layer_norm_bwd: mu and rstd must be [R] f32")
    dev = _check("layer_norm_bwd", x2d, weight, weight, g2d)
    _build.require_cuda("layer_norm_bwd", x2d, mu, rstd)
    w = weight.float().contiguous()
    # the kernel writes dweight/dbias in weight's type where it has one
    wtype = weight.dtype if weight.dtype in LN_TYPES else torch.float32
    dx = torch.empty_like(x2d)
    dw = torch.empty(D, device=dev, dtype=wtype)
    db = torch.empty(D, device=dev, dtype=wtype)
    if R == 0 or D == 0:
        return dx, dw.zero_().to(weight.dtype), db.zero_().to(weight.dtype)
    code = _build.DTYPE_CODE[x2d.dtype]
    lib = _build.library("layer_norm", _SIGNATURES)
    n = lib.ln_bwd_blocks(R, D, code)
    if n <= 0:
        raise ValueError(f"layer_norm_bwd: rows of D={D} are too wide for "
                         "the kernel")
    dwp = torch.empty((n, D), device=dev, dtype=torch.float32)
    dbp = torch.empty((n, D), device=dev, dtype=torch.float32)
    rc = lib.ln_bwd(x2d.data_ptr(), w.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), g2d.data_ptr(), dx.data_ptr(),
                    dwp.data_ptr(), dbp.data_ptr(), dw.data_ptr(),
                    db.data_ptr(), R, D, n, code,
                    _build.DTYPE_CODE[wtype], _build.stream_ptr(dev))
    _build.check(rc, "layer_norm_bwd")
    _build.count_launch(layer_norm_bwd, x2d)
    return dx, dw.to(weight.dtype), db.to(weight.dtype)


layer_norm_bwd.launches = 0
layer_norm_bwd.by_dtype = {}
layer_norm_bwd.shapes = set()


# -- the custom ops: each runs its wrapper above (inside the op, grad mode
# is off, as in an autograd Function's forward); the fake implementations
# give the outputs' shapes and types, and the forward ops' autograd
# formulas run the backward op

def _stats_fake(x2d):
    """Empty ``[R]`` mean and rstd in the compute type (float32, or
    float64 for the float64 plain route)."""
    t = torch.promote_types(x2d.dtype, torch.float32)
    return tuple(x2d.new_empty((x2d.shape[0],), dtype=t) for _ in range(2))


_T3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_T4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op(f"{_build.NAMESPACE}::layer_norm_fwd",
                         mutates_args=())
def _ln_fwd_op(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> _T3:
    return layer_norm_fwd(x2d, weight, bias, eps)


@_ln_fwd_op.register_fake
def _(x2d, weight, bias, eps=1e-5):
    return (torch.empty_like(x2d),) + _stats_fake(x2d)


@torch.library.custom_op(f"{_build.NAMESPACE}::add_layer_norm_fwd",
                         mutates_args=())
def _add_ln_fwd_op(x2d: torch.Tensor, y2d: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> _T4:
    return add_layer_norm_fwd(x2d, y2d, weight, bias, eps)


@_add_ln_fwd_op.register_fake
def _(x2d, y2d, weight, bias, eps=1e-5):
    return (torch.empty_like(x2d), torch.empty_like(x2d)) + _stats_fake(x2d)


@torch.library.custom_op(f"{_build.NAMESPACE}::layer_norm_bwd",
                         mutates_args=())
def _ln_bwd_op(x2d: torch.Tensor, weight: torch.Tensor, mu: torch.Tensor,
               rstd: torch.Tensor, g2d: torch.Tensor) -> _T3:
    return layer_norm_bwd(x2d, weight, mu, rstd, g2d)


@_ln_bwd_op.register_fake
def _(x2d, weight, mu, rstd, g2d):
    return (torch.empty_like(x2d), torch.empty_like(weight),
            torch.empty_like(weight))


def _ln_setup(ctx, inputs, output):
    x2d, weight, _, _ = inputs
    ctx.save_for_backward(x2d, weight, output[1], output[2])


def _ln_backward(ctx, g, _g_mu, _g_rs):
    """B7 on the cotangent of y (the statistics' are dropped: the
    custom_vjp's residuals have none)."""
    x2d, weight, mu, rs = ctx.saved_tensors
    dx, dw, db = _ln_bwd_op(x2d, weight, mu, rs,
                            g.to(x2d.dtype).contiguous())
    return dx, dw, db, None


def _add_ln_setup(ctx, inputs, output):
    _, y2d, weight, _, _ = inputs
    s, _, mu, rs = output
    ctx.save_for_backward(s, weight, mu, rs)
    ctx.y_dtype = y2d.dtype


def _add_ln_backward(ctx, gs, go, _g_mu, _g_rs):
    """Both addends get ``dLN/ds + g_s``, each in its own type."""
    s2d, weight, mu, rs = ctx.saved_tensors
    ds, dw, db = _ln_bwd_op(s2d, weight, mu, rs,
                            go.to(s2d.dtype).contiguous())
    dsum = ds if gs is None else (ds + gs.to(ds.dtype)).to(ds.dtype)
    # each addend's gradient in its own type (the JAX package returns
    # dsum in s's type for both; PyTorch would cast it the same way)
    return dsum, dsum.to(ctx.y_dtype), dw, db, None


_ln_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup)
_add_ln_fwd_op.register_autograd(_add_ln_backward,
                                 setup_context=_add_ln_setup)


class LayerNormFunction:
    """LayerNorm over the last axis of ``x`` ([..., D]) on the B5 forward
    and B7 backward kernels (the custom_vjp of ``layer_norm.py:175``): a
    caller of the custom op ``layer_norm_fwd``, whose registered autograd
    formula launches ``layer_norm_bwd``. On the CPU it runs their plain
    versions."""

    @staticmethod
    def apply(x, weight, bias, eps=1e-5):
        y = _ln_fwd_op(x.reshape(-1, x.shape[-1]).contiguous(), weight,
                       bias, eps)[0]
        return y.reshape(x.shape)


class AddLayerNormFunction:
    """``(s, LN(s))`` with ``s = x + y`` on the B6 forward and B7 backward
    kernels (the custom_vjp of ``layer_norm.py:207``): a caller of the
    custom op ``add_layer_norm_fwd``. On the CPU it runs the plain
    versions."""

    @staticmethod
    def apply(x, y, weight, bias, eps=1e-5):
        D = x.shape[-1]
        s, out, _, _ = _add_ln_fwd_op(
            x.reshape(-1, D).contiguous(), y.reshape(-1, D).contiguous(),
            weight, bias, eps)
        return s.reshape(x.shape), out.reshape(x.shape)


def fused_layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis of ``x`` ([..., D]) through
    :class:`LayerNormFunction`; the counterpart of ``paddle_tpu``'s
    ``fused_layer_norm``."""
    return LayerNormFunction.apply(x, weight, bias, eps)


def fused_add_layer_norm(x, y, weight, bias, eps=1e-5):
    """(x + y, LayerNorm(x + y)) through :class:`AddLayerNormFunction`;
    the counterpart of ``paddle_tpu``'s ``fused_add_layer_norm``."""
    return AddLayerNormFunction.apply(x, y, weight, bias, eps)
