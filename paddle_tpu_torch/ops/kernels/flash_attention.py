"""Flash attention (B1-B4): the forward ``(out, lse)`` of softmax
attention, its backward ``(dq, dk, dv)``, and the autograd formula that
joins them.

The port of ``paddle_tpu/ops/pallas/flash_attention.py``. The forward
kernels ``_fwd_kernel_resident`` (B1) and ``_fwd_kernel`` (B2) compute one
function, and one hand-written CUDA kernel for Hopper computes it here
(``csrc/flash_attention_fwd.cu``). The backward kernels ``_dq_kernel``
(B3) and ``_dkv_kernel`` (B4) stay two kernels
(``csrc/flash_attention_bwd.cu``). Each wrapper has its plain PyTorch
version and a launch count beside it. The forward op's autograd formula
is the counterpart of the ``flash_attention`` custom_vjp: it saves what
``_fa_fwd`` saves, ``(q, k, v, out, lse)``, and its backward computes
``delta = rowsum(dO * O)`` outside the kernels, as ``_backward`` does.

What bounds the kernels on the H100 is the rate of their products. All
three run them on the tensor cores (``mma.sync``), float32 through 3xTF32
(float32-accurate; a single TF32 pass is never used), bfloat16 and float16
through products in that type, with the probabilities and ds kept f32 in
registers. Head dims up to 256. The CUDA sources say what their designs
keep on chip.

Conventions of the function, kept from the Pallas kernels: q is
``[B, H, S, D]``, k and v ``[B, H, Sk, D]``; a masked score is ``-1e30``;
the causal mask compares GLOBAL positions, ``kv_offset + j > q_offset +
i``; a row with every key masked returns out = 0 and lse = ``-1e30``, and
in backward ``p`` is forced to 0 wherever ``s <= -1e30 / 2``; outputs come
back in the input type and lse as ``[B, H, S]`` f32; the block contract
raises when S or Sk is not divisible by its block.

Each kernel is a ``torch.library`` custom op,
``torch.ops.paddle_tpu_torch.flash_attention_{fwd,bwd_dq,bwd_dkv}``, with
a fake implementation (its outputs' shapes and types, for fake-tensor
tracing: ``torch.export``, the static recorder's probe) and, on the
forward, an autograd formula that runs the backward ops; so an exported
program records the op itself and keeps its gradient. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises. A
wrapper function called directly with an input that requires grad while
grad mode is on raises on either device (its outputs would be cut from
the graph): training goes through :class:`FlashAttentionFunction`.

Ring attention's building block, ``flash_attention_partial`` (the JAX
package's ``flash_attention_partial``), is a fourth custom op over the
same kernels: the B1 forward's unmerged ``(out, lse)`` of one KV shard,
whose autograd formula takes the lse cotangent too and folds it into
delta (``delta = rowsum(g_out * out) - g_lse``) before the B3/B4 ops.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._build import upcast as _up

NEG = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                  _P],
}
_BWD_SIGNATURES = {
    "flash_bwd_dq": [_P] * 7 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
}
SOURCE = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
BWD_SOURCE = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
_FUNCTION = "ops.kernels.flash_attention.FlashAttentionFunction"
#: query rows per thread block of the forward kernel (grid y <= 65535)
_KERNEL_BLOCK_Q = 64
#: the widest head the kernels take (tiles of 64, 128 or 256 columns)
MAX_HEAD_DIM = 256


def _check_blocks(S, Sk, block_q, block_k):
    bq, bk = min(block_q, S), min(block_k, Sk)
    if S % bq or Sk % bk:
        raise ValueError(
            f"flash_attention: S={S}/Sk={Sk} must be divisible by "
            f"block_q={bq}/block_k={bk}")


def _check_qkv(q, k, v):
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not form [B, H, S|Sk, D]")
    return B, H, S, Sk, D


def _check_cuda(what, q, k, v, *more):
    dev = _build.require_cuda(what, q, k, v, *more)
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one type of float32, "
                        "bfloat16, float16")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    return dev


def _scores(q, k, scale, causal, q_offset, kv_offset):
    """Masked scores ``q k^T * scale`` in the compute type."""
    S, Sk = q.shape[2], k.shape[2]
    s = torch.matmul(_up(q), _up(k).transpose(-1, -2)) * scale
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        kpos = kv_offset + torch.arange(Sk, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG)
    return s


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale=None,
                              q_offset=0, kv_offset=0):
    """Plain PyTorch version of the flash forward: the same function with
    the scores materialized. Returns (out in q's type, lse [B, H, S] in the
    compute type)."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    s = _scores(q, k, scale, causal, q_offset, kv_offset)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG / 2
    p = torch.where(alive, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, _up(v)) / safe_l
    lse = torch.where(l == 0, torch.full_like(l, NEG), m + torch.log(safe_l))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_fwd(q, k, v, *, causal=False, block_q=256,
                        block_k=256, scale=None, q_offset=0, kv_offset=0):
    """Flash-attention forward -> (out ``[B, H, S, D]`` in q's type, lse
    ``[B, H, S]`` f32). ``block_q``/``block_k`` are the Pallas kernels'
    tiles, kept for their contract (S and Sk divisible by them); the CUDA
    kernel tiles by its own sizes. ``q_offset``/``kv_offset`` shift the
    global positions the causal mask compares (``q_offset = Sk - Sq`` is
    the end-aligned decode-append shape)."""
    _build.refuse_grad("flash_attention_fwd", _FUNCTION, q, k, v)
    B, H, S, Sk, D = _check_qkv(q, k, v)
    _check_blocks(S, Sk, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset)
    dev = _check_cuda("flash_attention_fwd", q, k, v)
    if -(-S // _KERNEL_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention_fwd: S={S} too long for the grid")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), device=dev, dtype=torch.float32)
    lib = _build.library("flash_attention_fwd", _FWD_SIGNATURES)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), B * H, S, Sk, D,
                       float(scale), int(bool(causal)), int(q_offset),
                       int(kv_offset), _build.DTYPE_CODE[q.dtype],
                       _build.stream_ptr(dev))
    _build.check(rc, "flash_attention_fwd")
    _build.count_launch(flash_attention_fwd, q)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.by_dtype = {}
flash_attention_fwd.shapes = set()


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, *, causal=False,
                              scale=None, q_offset=0, kv_offset=0):
    """Plain PyTorch version of the B3/B4 backward, written from the Pallas
    kernels' formulas (not from autograd): ``p = exp(s - lse)`` (0 where
    ``s <= -1e30/2``), ``ds = p (dO v^T - delta) scale``, ``dq = ds k``,
    ``dk = ds^T q``, ``dv = p^T dO``. Returns (dq, dk, dv) in the input
    types."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    s = _scores(q, k, scale, causal, q_offset, kv_offset)
    p = torch.where(s <= NEG / 2, torch.zeros_like(s),
                    torch.exp(s - _up(lse)[..., None]))
    do = _up(dout)
    dp = torch.matmul(do, _up(v).transpose(-1, -2))
    ds = p * (dp - _up(delta)[..., None]) * scale
    dq = torch.matmul(ds, _up(k))
    dk = torch.matmul(ds.transpose(-1, -2), _up(q))
    dv = torch.matmul(p.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(what, q, k, v, dout, lse, delta):
    B, H, S, Sk, D = _check_qkv(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout must match q in shape and type")
    for t in (lse, delta):
        if t.shape != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{what}: lse and delta must be [B, H, S] f32")
    dev = _check_cuda(what, q, k, v, dout, lse, delta)
    return dev, B, H, S, Sk, D


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal=False,
                           scale=None, q_offset=0, kv_offset=0):
    """dq of the flash backward (B3, ``_dq_kernel``)."""
    _build.refuse_grad("flash_attention_bwd_dq", _FUNCTION, q, k, v, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, dout, lse, delta, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset)[0]
    dev, B, H, S, Sk, D = _bwd_args("flash_attention_bwd_dq", q, k, v, dout,
                                    lse, delta)
    scale = scale if scale is not None else D ** -0.5
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), B * H, S, Sk, D, float(scale),
                          int(bool(causal)), int(q_offset), int(kv_offset),
                          _build.DTYPE_CODE[q.dtype], _build.stream_ptr(dev))
    _build.check(rc, "flash_attention_bwd_dq")
    _build.count_launch(flash_attention_bwd_dq, q)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal=False,
                            scale=None, q_offset=0, kv_offset=0):
    """(dk, dv) of the flash backward (B4, ``_dkv_kernel``)."""
    _build.refuse_grad("flash_attention_bwd_dkv", _FUNCTION, q, k, v, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, dout, lse, delta, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset)[1:]
    dev, B, H, S, Sk, D = _bwd_args("flash_attention_bwd_dkv", q, k, v,
                                    dout, lse, delta)
    scale = scale if scale is not None else D ** -0.5
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_attention_bwd", _BWD_SIGNATURES)
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), B * H, S, Sk, D,
                           float(scale), int(bool(causal)), int(q_offset),
                           int(kv_offset), _build.DTYPE_CODE[q.dtype],
                           _build.stream_ptr(dev))
    _build.check(rc, "flash_attention_bwd_dkv")
    _build.count_launch(flash_attention_bwd_dkv, q)
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.by_dtype = {}
flash_attention_bwd_dq.shapes = set()
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.by_dtype = {}
flash_attention_bwd_dkv.shapes = set()


def flash_attention_bwd(q, k, v, dout, lse, delta, *, causal=False,
                        block_q=256, block_k=256, scale=None, q_offset=0,
                        kv_offset=0):
    """Flash-attention backward -> (dq, dk, dv) in the input types: the
    counterpart of ``_backward_with_delta``. ``delta`` is
    ``rowsum(dO * O)`` ([B, H, S] f32), computed by the caller (the ring
    attention's partial backward shifts it by the lse cotangent)."""
    _build.refuse_grad("flash_attention_bwd", _FUNCTION, q, k, v, dout)
    _check_qkv(q, k, v)
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# -- the custom ops: each runs its wrapper above (inside the op, grad mode
# is off, as in an autograd Function's forward); the fake implementations
# give the outputs' shapes and types, and the forward op's autograd formula
# runs the backward ops

@torch.library.custom_op(f"{_build.NAMESPACE}::flash_attention_fwd",
                         mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = False, block_q: int = 256, block_k: int = 256,
            scale: Optional[float] = None, q_offset: int = 0,
            kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k, scale=scale,
                               q_offset=q_offset, kv_offset=kv_offset)


@_fwd_op.register_fake
def _(q, k, v, causal=False, block_q=256, block_k=256, scale=None,
      q_offset=0, kv_offset=0):
    B, H, S, Sk, _ = _check_qkv(q, k, v)
    _check_blocks(S, Sk, block_q, block_k)
    # lse in the compute type: float32, float64 on the float64 plain route
    lse_type = torch.promote_types(q.dtype, torch.float32)
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=lse_type)


@torch.library.custom_op(f"{_build.NAMESPACE}::flash_attention_bwd_dq",
                         mutates_args=())
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
           causal: bool = False, scale: Optional[float] = None,
           q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    return flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal,
                                  scale=scale, q_offset=q_offset,
                                  kv_offset=kv_offset)


@_dq_op.register_fake
def _(q, k, v, dout, lse, delta, causal=False, scale=None, q_offset=0,
      kv_offset=0):
    return torch.empty_like(q)


@torch.library.custom_op(f"{_build.NAMESPACE}::flash_attention_bwd_dkv",
                         mutates_args=())
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            causal: bool = False, scale: Optional[float] = None,
            q_offset: int = 0, kv_offset: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal,
                                   scale=scale, q_offset=q_offset,
                                   kv_offset=kv_offset)


@_dkv_op.register_fake
def _(q, k, v, dout, lse, delta, causal=False, scale=None, q_offset=0,
      kv_offset=0):
    return torch.empty_like(k), torch.empty_like(v)


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal, _, _, scale, q_offset, kv_offset = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.kw = (causal, scale, q_offset, kv_offset)


def _fwd_backward(ctx, g, _g_lse):
    """The custom_vjp's backward: ``delta = rowsum(dO * O)`` outside the
    kernels, as ``_backward`` computes it, then the B3 and B4 ops (the
    lse cotangent is dropped, as ``flash_attention``'s residual has none).
    On the CPU one plain backward gives dq, dk and dv together."""
    q, k, v, out, lse = ctx.saved_tensors
    delta = (_up(g) * _up(out)).sum(dim=-1).to(lse.dtype)
    g = g.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        causal, scale, q_offset, kv_offset = ctx.kw
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, g, lse, delta, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset)
    else:
        dq = _dq_op(q, k, v, g, lse, delta, *ctx.kw)
        dk, dv = _dkv_op(q, k, v, g, lse, delta, *ctx.kw)
    return dq, dk, dv, None, None, None, None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


# -- the ring's building block: the unmerged partial (out, lse) of one KV
# shard, whose autograd formula takes the lse cotangent

@torch.library.custom_op(f"{_build.NAMESPACE}::flash_attention_partial",
                         mutates_args=())
def _partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = False, block_q: int = 256, block_k: int = 256,
                scale: Optional[float] = None, q_offset: int = 0,
                kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cuda":
        flash_attention_partial.launches += 1
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k, scale=scale,
                               q_offset=q_offset, kv_offset=kv_offset)


@_partial_op.register_fake
def _(q, k, v, causal=False, block_q=256, block_k=256, scale=None,
      q_offset=0, kv_offset=0):
    B, H, S, Sk, _ = _check_qkv(q, k, v)
    _check_blocks(S, Sk, block_q, block_k)
    lse_type = torch.promote_types(q.dtype, torch.float32)
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=lse_type)


def partial_backward(q, k, v, out, lse, g_out, g_lse, *, causal=False,
                     scale=None, q_offset=0, kv_offset=0):
    """(dq, dk, dv) of a partial ``(out, lse)`` given the cotangents of
    both (``_fap_bwd``): the lse cotangent folds into delta, ``delta =
    rowsum(g_out * out) - g_lse`` (``ds = p (dp - delta) + p g_lse``), then
    the B3/B4 ops with that delta; the plain backward on the CPU. A None
    cotangent counts as zeros."""
    if g_out is None:
        g_out = torch.zeros_like(out)
    delta = (_up(g_out) * _up(out)).sum(dim=-1).to(lse.dtype)
    if g_lse is not None:
        delta = delta - g_lse.to(delta.dtype)
    g = g_out.to(q.dtype).contiguous()
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, g, lse, delta, **kw)
    delta = delta.contiguous()
    dq = _dq_op(q, k, v, g, lse, delta, causal, scale, q_offset, kv_offset)
    dk, dv = _dkv_op(q, k, v, g, lse, delta, causal, scale, q_offset,
                     kv_offset)
    return dq, dk, dv


def _partial_backward(ctx, g_out, g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    causal, scale, q_offset, kv_offset = ctx.kw
    dq, dk, dv = partial_backward(q, k, v, out, lse, g_out, g_lse,
                                  causal=causal, scale=scale,
                                  q_offset=q_offset, kv_offset=kv_offset)
    return dq, dk, dv, None, None, None, None, None, None


_partial_op.register_autograd(_partial_backward, setup_context=_fwd_setup)


def flash_attention_partial(q, k, v, causal=False, block_q=256, block_k=256,
                            scale=None, q_offset=0, kv_offset=0):
    """Ring attention's building block (``flash_attention_partial`` of
    ``flash_attention.py:421``): the B1/B2 forward over one KV shard with
    GLOBAL position offsets, returning its UNMERGED ``(out, lse)``; a row
    with every key masked gives ``(0, -1e30)``, which the ring's merge
    weighs 0. Differentiable in both outputs: the custom op
    ``flash_attention_partial``, whose autograd formula
    (:func:`partial_backward`) folds the lse cotangent into delta and runs
    the B3/B4 ops. ``flash_attention_partial.launches`` counts its calls
    on a CUDA tensor (each launches B1)."""
    return _partial_op(q, k, v, causal, block_q, block_k, scale, q_offset,
                       kv_offset)


flash_attention_partial.launches = 0


class FlashAttentionFunction:
    """``flash_attention`` with its backward on the B3/B4 kernels (the
    custom_vjp of ``flash_attention.py:376``): a caller of the custom op
    ``flash_attention_fwd``, whose registered autograd formula launches
    the backward ops, so ``torch.export`` records the op itself and a
    captured program keeps its gradient. On the CPU its forward and
    backward run the plain versions. Returns ``out``."""

    @staticmethod
    def apply(q, k, v, causal=False, block_q=256, block_k=256, scale=None,
              q_offset=0, kv_offset=0):
        return _fwd_op(q, k, v, causal, block_q, block_k, scale, q_offset,
                       kv_offset)[0]
