"""The GPT block of ``paddle_tpu/distributed/meta_parallel.py``, single
device (mp = 1).

``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelMultiHeadAttention`` and ``ParallelGPTBlock`` compute what the
JAX layers compute on a trivial mesh. Sharding over ``mp`` belongs to a
later slice: every layer here raises on ``mp > 1``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as F
from ..nn.functional import attention as attn_route
from ..nn.layers.common import Linear
from ..nn.layers.norm import LayerNorm
from ..nn.layers.transformer import MultiHeadAttention

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "ParallelMultiHeadAttention", "ParallelGPTBlock"]


def _single_device(mp: int, what: str) -> None:
    if int(mp) != 1:
        raise NotImplementedError(
            f"{what}: mp={mp} — the port runs the single-device form "
            "(mp = 1) only so far")


class ColumnParallelLinear(Linear):
    """Column-partitioned linear; with mp = 1 a plain ``Linear``."""

    def __init__(self, in_features, out_features, *, mp=1, device,
                 dtype=torch.float32, generator):
        _single_device(mp, "ColumnParallelLinear")
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype, generator=generator)


class RowParallelLinear(Linear):
    """Row-partitioned linear; with mp = 1 a plain ``Linear``."""

    def __init__(self, in_features, out_features, *, mp=1, device,
                 dtype=torch.float32, generator):
        _single_device(mp, "RowParallelLinear")
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype, generator=generator)


class ParallelMultiHeadAttention(nn.Module):
    """Causal self-attention with a fused ``[d, 3d]`` qkv projection.

    Full forward: the flash kernel when ``flash_plan`` routes it (the
    flash-by-default policy), else the dense form with a ``triu(-1e9)``
    mask. Cached forward (serving): write this step's K/V at per-slot
    ``pos`` first, then attend over the whole capacity with the position
    mask (``cached_attention``). Attention dropout comes with training."""

    def __init__(self, embed_dim, num_heads, mp=1, *, device,
                 dtype=torch.float32, generator):
        super().__init__()
        _single_device(mp, "ParallelMultiHeadAttention")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide into num_heads")
        self.num_heads = int(num_heads)
        self.head_dim = embed_dim // num_heads
        self.qkv = ColumnParallelLinear(
            embed_dim, 3 * embed_dim, device=device, dtype=dtype,
            generator=generator)
        self.out_proj = RowParallelLinear(
            embed_dim, embed_dim, device=device, dtype=dtype,
            generator=generator)

    def gen_cache(self, batch_size, max_length, dtype=None):
        """Zero ``[B, H, cap, Dh]`` K/V buffers in the layer's dtype."""
        w = self.qkv.weight
        shape = (int(batch_size), self.num_heads, int(max_length),
                 self.head_dim)
        dt = dtype or w.dtype
        return MultiHeadAttention.Cache(
            torch.zeros(shape, device=w.device, dtype=dt),
            torch.zeros(shape, device=w.device, dtype=dt))

    def forward(self, x, cache=None, pos=None):
        B, T = int(x.shape[0]), int(x.shape[1])
        H, dh = self.num_heads, self.head_dim
        # [B, T, 3D] -> [3, B, H, T, dh]: the 3 is outermost in the fused
        # projection's output features, heads next
        qkv = self.qkv(x).reshape(B, T, 3, H, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if cache is not None:
            if pos is None:
                raise ValueError("cache decoding needs `pos` (per-slot "
                                 "write positions [B] int32)")
            # write before attend: this step's rows must be visible to its
            # own queries; padded prefill rows land past every real query
            # position, where the mask hides them
            k = attn_route.cache_update(cache.k, k, pos)
            v = attn_route.cache_update(cache.v, v, pos)
            ctx = attn_route.cached_attention(q, k, v, pos, scale=dh ** -0.5)
            ctx = ctx.transpose(1, 2).reshape(B, T, H * dh)
            return self.out_proj(ctx), MultiHeadAttention.Cache(k, v)
        if attn_route.flash_plan(T, T, causal=True, device=x.device):
            ctx = attn_route.flash_core(q, k, v, causal=True)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
            mask = torch.triu(torch.full((T, T), -1e9, device=x.device,
                                         dtype=torch.float32), diagonal=1)
            ctx = torch.matmul(torch.softmax(scores + mask, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(B, T, H * dh)
        return self.out_proj(ctx)


class ParallelGPTBlock(nn.Module):
    """Pre-LN GPT decoder block: ``ln1`` -> attention -> residual-add + LN
    (one B6 kernel when routed) -> fc1 -> exact GELU -> fc2 -> residual."""

    def __init__(self, d_model, num_heads, dim_feedforward=None, mp=1, *,
                 device, dtype=torch.float32, generator):
        super().__init__()
        _single_device(mp, "ParallelGPTBlock")
        ffn = dim_feedforward or 4 * d_model
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = int(d_model)
        self.ln1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.attn = ParallelMultiHeadAttention(d_model, num_heads, **kw)
        self.ln2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.fc1 = ColumnParallelLinear(d_model, ffn, **kw)
        self.fc2 = RowParallelLinear(ffn, d_model, **kw)

    def forward(self, x, cache=None, pos=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache, pos=pos)
        else:
            a, new_cache = self.attn(self.ln1(x)), None
        h, n2 = F.fused_residual_layer_norm(
            x, a, [self.d_model], self.ln2.weight, self.ln2.bias,
            self.ln2.epsilon)
        out = h + self.fc2(F.gelu(self.fc1(n2)))
        return out if new_cache is None else (out, new_cache)

    def gen_cache(self, batch_size, max_length, dtype=None):
        return self.attn.gen_cache(batch_size, max_length, dtype)
