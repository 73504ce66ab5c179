"""Flash-attention forward (B1/B2): ``(out, lse)`` of softmax attention.

The port of ``paddle_tpu/ops/pallas/flash_attention.py``'s forward
kernels, ``_fwd_kernel_resident`` (B1) and ``_fwd_kernel`` (B2). Both
compute one function, and one hand-written CUDA kernel for Hopper
(``csrc/flash_attention_fwd.cu``) computes it here; its plain PyTorch
version and a launch count sit beside the wrapper. The backward kernels
(B3, B4) come with the training slice.

What bounds the kernel on the H100 at the serving shapes is the f32 SIMT
rate of its products (it does not use the tensor cores yet); the CUDA
source says what its design keeps on chip.

Conventions of the function, kept from the Pallas kernels: q is
``[B, H, S, D]``, k and v ``[B, H, Sk, D]``; a masked score is ``-1e30``;
the causal mask compares GLOBAL positions, ``kv_offset + j > q_offset +
i``; a row with every key masked returns out = 0 and lse = ``-1e30``; out
comes back in the input type and lse as ``[B, H, S]`` f32; the block
contract raises when S or Sk is not divisible by its block.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                  _P],
}
SOURCE = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
#: query rows per thread block of the CUDA kernel (grid y is at most 65535)
_KERNEL_BLOCK_Q = 16


def _check_blocks(S, Sk, block_q, block_k):
    bq, bk = min(block_q, S), min(block_k, Sk)
    if S % bq or Sk % bk:
        raise ValueError(
            f"flash_attention: S={S}/Sk={Sk} must be divisible by "
            f"block_q={bq}/block_k={bk}")


def flash_attention_fwd_plain(q, k, v, *, causal=False, scale=None,
                              q_offset=0, kv_offset=0):
    """Plain PyTorch version of the flash forward: the same function with
    the scores materialized. Returns (out in q's type, lse [B, H, S] f32).
    """
    S, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        kpos = kv_offset + torch.arange(Sk, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG / 2
    p = torch.where(alive, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, v.float()) / safe_l
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
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not form [B, H, S|Sk, D]")
    _check_blocks(S, Sk, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            kv_offset=kv_offset)
    dev = _build.require_cuda("flash_attention_fwd", q, k, v)
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd: q, k, v must share one type "
                        "of float32, bfloat16")
    if D > 128:
        raise ValueError(f"flash_attention_fwd: head dim {D} > 128")
    if -(-S // _KERNEL_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention_fwd: S={S} too long for the grid")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), device=dev, dtype=torch.float32)
    lib = _build.library("flash_attention_fwd", _SIGNATURES)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), B * H, S, Sk, D,
                       float(scale), int(bool(causal)), int(q_offset),
                       int(kv_offset), _build.DTYPE_CODE[q.dtype],
                       _build.stream_ptr(dev))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
