"""Blockwise (online-softmax) attention: the one-device part of
``paddle_tpu/nn/layers/ring_attention.py``.

``blockwise_attention(q, k, v)`` over ``[B, H, S, D]`` is exact softmax
attention that visits the keys a block at a time, keeping a running max
``m``, sum ``l`` and output ``o`` in float32 (``_block_step``), so no
``[S, Sk]`` score matrix lives at once. The JAX package routes it, on a
single TPU chip, to its Pallas flash kernel when S and Sk divide by their
blocks; the port routes a CUDA tensor of such a shape to
``FlashAttentionFunction`` (the B1/B2 forward and B3/B4 backward kernels,
``causal`` passed through), whose kernels launch or raise. Every other
shape, and the CPU, take the torch blockwise program, as the JAX package
does off the TPU: up to ``_UNROLL_BLOCKS`` blocks an unrolled loop that
autograd differentiates, beyond it ``_BlockwiseScan``, the counterpart of
the custom-VJP ``_blockwise_scan``, whose backward recomputes each block's
probabilities from the saved ``lse`` (FlashAttention-2's backward) so that
only q, k, v, out and lse are kept. Under AMP the kernel route casts q, k
and v as the white-listed ``flash_attention``; the torch route is
``blockwise_attention``, on neither list, as in the JAX package.

Ring and Ulysses attention (sequence parallel over a mesh) are ROADMAP
queue A item 7.
"""
from __future__ import annotations

import torch

from ... import amp
from ...core.tensor import tensor_boundary
from ...ops.kernels.flash_attention import FlashAttentionFunction

__all__ = ["blockwise_attention"]

_NEG = -1e30
#: more blocks than this take the recomputing scan (``_BlockwiseScan``)
_UNROLL_BLOCKS = 16


def _block_step(q, k, v, scale, o, m, l, mask=None):
    """One online-softmax step over a key block: q ``[B,H,Sq,D]`` and k
    f32, v ``[B,H,Sk,D]``, o ``[B,H,Sq,D]`` f32, m and l ``[B,H,Sq]`` f32;
    ``mask`` ``[Sq,Sk]`` additive. Returns the new (o, m, l)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return o_new, m_new, l_new


def _start(q):
    B, H, S, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(B, H, S, D, **f32),
            torch.full((B, H, S), _NEG, **f32), torch.zeros(B, H, S, **f32))


def _blockwise_raw(q, k, v, *, causal=False, block_size=512, scale=None):
    """The torch blockwise program (``_blockwise_raw``)."""
    S, D, Sk = q.shape[2], q.shape[3], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    block = min(block_size, Sk)
    n_blocks = -(-Sk // block)
    if n_blocks > _UNROLL_BLOCKS:
        return _BlockwiseScan.apply(q, k, v, causal, block, scale)
    qf = q.float()
    qpos = torch.arange(S, device=q.device)
    o, m, l = _start(q)
    for j in range(n_blocks):
        lo, hi = j * block, min((j + 1) * block, Sk)
        mask = None
        if causal:
            kpos = torch.arange(lo, hi, device=q.device)
            mask = torch.where(kpos[None, :] > qpos[:, None], _NEG, 0.0)
        o, m, l = _block_step(qf, k[:, :, lo:hi].float(), v[:, :, lo:hi],
                              scale, o, m, l, mask)
    return (o / l[..., None]).to(q.dtype)


def _block_masks(S, Sk, block, n_blocks, causal, device):
    """Per block j: (lo, ``[S, block]`` bool of the keys it may not see:
    padding past Sk, and the future when causal)."""
    qpos = torch.arange(S, device=device)
    for j in range(n_blocks):
        kpos = j * block + torch.arange(block, device=device)
        invalid = (kpos[None, :] >= Sk).expand(S, block)
        if causal:
            invalid = invalid | (kpos[None, :] > qpos[:, None])
        yield j * block, invalid


def _padded(t, n):
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


class _BlockwiseScan(torch.autograd.Function):
    """The blockwise forward over padded key blocks, saving (q, k, v, out,
    lse); its backward recomputes ``p = exp(s - lse)`` per block (0 where
    the score is masked), ``ds = p (dO v^T - delta) scale`` with ``delta =
    rowsum(dO * out)``, and accumulates dq while each block writes its dk
    and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block, scale):
        S, Sk = q.shape[2], k.shape[2]
        n_blocks = -(-Sk // block)
        kp, vp = _padded(k, n_blocks * block), _padded(v, n_blocks * block)
        qf = q.float()
        o, m, l = _start(q)
        for lo, invalid in _block_masks(S, Sk, block, n_blocks, causal,
                                        q.device):
            mask = torch.where(invalid, _NEG, 0.0)
            o, m, l = _block_step(qf, kp[:, :, lo:lo + block].float(),
                                  vp[:, :, lo:lo + block], scale, o, m, l,
                                  mask)
        out = (o / l[..., None]).to(q.dtype)
        lse = m + torch.log(l.clamp(min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block, scale = ctx.args
        S, Sk = q.shape[2], k.shape[2]
        n_blocks = -(-Sk // block)
        kp, vp = _padded(k, n_blocks * block), _padded(v, n_blocks * block)
        qf, gf = q.float(), g.float()
        delta = (gf * out.float()).sum(dim=-1)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for lo, invalid in _block_masks(S, Sk, block, n_blocks, causal,
                                        q.device):
            kj = kp[:, :, lo:lo + block].float()
            vj = vp[:, :, lo:lo + block].float()
            s = torch.where(invalid, _NEG,
                            torch.matmul(qf, kj.transpose(-1, -2)) * scale)
            p = torch.where(s <= _NEG / 2, 0.0, torch.exp(s - lse[..., None]))
            dp = torch.matmul(gf, vj.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.matmul(ds, kj)
            dks.append(torch.matmul(ds.transpose(-1, -2), qf))
            dvs.append(torch.matmul(p.transpose(-1, -2), gf))
        dk = torch.cat(dks, dim=2)[:, :, :Sk]
        dv = torch.cat(dvs, dim=2)[:, :, :Sk]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def kernel_route(q, k, block_size):
    """Does ``blockwise_attention`` go to the flash kernels? A CUDA
    tensor of four axes whose S and Sk divide by their blocks."""
    S, Sk = q.shape[2], k.shape[2]
    return (q.device.type == "cuda" and q.dim() == 4
            and S % min(block_size, S) == 0
            and Sk % min(block_size, Sk) == 0)


@tensor_boundary
def blockwise_attention(q, k, v, causal=False, block_size=512, scale=None):
    """Exact softmax attention over ``[B, H, S, D]`` with O(block) score
    memory: the flash kernels on a CUDA tensor whose S and Sk divide by
    ``min(block_size, S)`` and ``min(block_size, Sk)`` (they launch or
    raise), the torch blockwise program otherwise. ``causal`` masks key j
    from query i when j > i."""
    if kernel_route(q, k, block_size):
        q, k, v = amp.cast_if_amp("flash_attention", (q, k, v))
        return FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal,
            min(block_size, q.shape[2]), min(block_size, k.shape[2]), scale,
            0, 0)
    q, k, v = amp.cast_if_amp("blockwise_attention", (q, k, v))
    return _blockwise_raw(q, k, v, causal=causal, block_size=block_size,
                          scale=scale)
