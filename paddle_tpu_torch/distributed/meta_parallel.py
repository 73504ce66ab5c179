"""The GPT block of ``paddle_tpu/distributed/meta_parallel.py``, single
device (mp = 1).

``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelMultiHeadAttention`` and ``ParallelGPTBlock`` compute what the
JAX layers compute on a trivial mesh, with the JAX package's arguments in
its order; ``device``, ``dtype`` and ``generator`` are keyword-only (the
package defaults when None). Sharding over ``mp`` belongs to a later
slice: every layer here raises on a keyword ``mp`` other than 1, and
``gather_output`` / ``input_is_parallel`` change nothing on one device.

Under AMP O1 the block's types flow as in the JAX package: the residual
stream stays float32, the projections (``linear``) and the attention
products run in bfloat16, and the residual sums come back float32 (a
float32 tensor plus a bfloat16 one). Dropout draws its masks from the
``torch.Generator`` the layer was built with.
"""
from __future__ import annotations

import torch

from .. import amp
from . import quantized_comm as qc
from ..nn import functional as F
from ..nn.functional import attention as attn_route
from ..nn.layer import Layer
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
    """Column-partitioned linear; with mp = 1 a plain ``Linear``
    (``has_bias=False`` drops the bias)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, bias_attr=None,
                 name=None, *, mp=1, device=None, dtype=None,
                 generator=None):
        _single_device(mp, "ColumnParallelLinear")
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr if has_bias else False, device=device,
                         dtype=dtype, generator=generator)


class RowParallelLinear(Linear):
    """Row-partitioned linear; with mp = 1 a plain ``Linear``
    (``has_bias=False`` drops the bias)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, bias_attr=None,
                 name=None, *, mp=1, device=None, dtype=None,
                 generator=None):
        _single_device(mp, "RowParallelLinear")
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr if has_bias else False, device=device,
                         dtype=dtype, generator=generator)


class ParallelMultiHeadAttention(Layer):
    """Self-attention (causal unless ``causal=False``) with a fused ``[d,
    3d]`` qkv projection.

    Full forward: the flash kernel when ``use_flash_attention`` is True,
    or when it is None (the default) and ``flash_plan`` routes it (the
    flash-by-default policy of ``PADDLE_FLASH_DEFAULT``, which declines
    while attention dropout is active: the kernel never materializes the
    probabilities); else, and always with ``use_flash_attention=False``,
    the dense form: scores (``matmul``), a ``triu(-1e9)`` mask when
    causal, ``softmax``, dropout, then the context product (``matmul``).
    Cached forward (serving): write this step's K/V at per-slot ``pos``
    first, then attend over the whole capacity with the position mask
    (``cached_attention``)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, causal=True,
                 weight_attr=None, bias_attr=None, use_flash_attention=None,
                 *, mp=1, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        _single_device(mp, "ParallelMultiHeadAttention")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide into num_heads")
        if use_flash_attention and dropout:
            raise ValueError(
                "use_flash_attention requires dropout=0.0: the flash "
                "kernel never materializes the attention probabilities")
        self.num_heads = int(num_heads)
        self.head_dim = embed_dim // num_heads
        self.causal = bool(causal)
        self.dropout = float(dropout)
        self.use_flash_attention = use_flash_attention
        self._generator = generator
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = ColumnParallelLinear(
            embed_dim, 3 * embed_dim, weight_attr, bias_attr=bias_attr,
            gather_output=False, **kw)
        self.out_proj = RowParallelLinear(
            embed_dim, embed_dim, weight_attr, bias_attr=bias_attr,
            input_is_parallel=True, **kw)

    def gen_cache(self, batch_size, max_length, dtype=None,
                  block_size=None, pool_blocks=None):
        """Zero ``[B, H, cap, Dh]`` K/V buffers in the layer's dtype; or,
        with ``block_size`` (the ``PADDLE_SERVE_BLOCK_SIZE`` default when
        not given; an explicit value wins), a paged cache: a ``[P, H, bs,
        Dh]`` block pool and a ``[B, nmax]`` table per K and V
        (``serving.paged_kv.PagedKV``), the capacity rounded up to whole
        blocks. ``pool_blocks`` sizes the pool (tables start all-trash);
        without it the tables are identity-mapped. ``dtype="int8"`` or
        ``"fp8"`` (the ``PADDLE_SERVE_KV_QUANT`` default when not given)
        makes either form block-quantized (``QuantKV``: the narrow payload
        at the cache's shape, float32 scales per block of the head dim)."""
        from ..serving import paged_kv as pk  # serving imports this module

        kvq = qc.kv_quant_policy(dtype)
        dev = self.qkv.weight.device
        # a narrow weight has no float type: the bias's is the cache's
        b = self.qkv.bias
        dt = dtype or (b.dtype if b is not None else self._dtype)
        bs = (int(block_size) if block_size is not None
              else pk.block_size_default())
        if bs > 0:
            return MultiHeadAttention.Cache(*(pk.paged_zero(
                batch_size, self.num_heads, max_length, self.head_dim,
                block=bs, pool_blocks=pool_blocks,
                dtype=None if kvq else dt, quant=kvq, device=dev)
                for _ in range(2)))
        shape = (int(batch_size), self.num_heads, int(max_length),
                 self.head_dim)
        if kvq is not None:
            return MultiHeadAttention.Cache(
                *(qc.kv_zero(shape, kvq, device=dev) for _ in range(2)))
        return MultiHeadAttention.Cache(
            torch.zeros(shape, device=dev, dtype=dt),
            torch.zeros(shape, device=dev, dtype=dt))

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
        route = self.use_flash_attention
        if route is None:
            route = attn_route.flash_plan(
                T, T, causal=self.causal, device=x.device,
                dropout_active=bool(self.dropout) and self.training)
        if route:
            ctx = attn_route.flash_core(q, k, v, causal=self.causal)
        else:
            ctx = self._dense(q, k, v, T)
        ctx = ctx.transpose(1, 2).reshape(B, T, H * dh)
        return self.out_proj(ctx)

    def _dense(self, q, k, v, T):
        qr, kr = amp.cast_if_amp("matmul", (q, k))
        scores = torch.matmul(qr, kr.transpose(-1, -2)) * (self.head_dim
                                                           ** -0.5)
        if self.causal:
            scores = scores + torch.triu(torch.full(
                (T, T), -1e9, device=q.device, dtype=torch.float32),
                diagonal=1)
        (scores,) = amp.cast_if_amp("softmax", (scores,))
        attn = torch.softmax(scores, dim=-1)
        if self.dropout:
            attn = F.dropout(attn, self.dropout, training=self.training,
                             generator=self._generator)
        attn, vr = amp.cast_if_amp("matmul", (attn, v))
        return torch.matmul(attn, vr)


class ParallelGPTBlock(Layer):
    """Pre-LN GPT decoder block: ``ln1`` -> attention -> residual-add + LN
    (one B6 kernel when routed) -> fc1 -> exact GELU -> dropout -> fc2 ->
    residual. ``dropout`` applies to the attention probabilities (on the
    dense route, which it selects while training) and to the MLP's hidden
    activations. With an ``AdapterSet`` attached (buffers ``adapter_A``
    ``[n, r, d]`` and ``adapter_B`` ``[n, ffn, r]``), ``adapter=`` ([B]
    int ids) adds each row's low-rank delta to ``fc1``'s output, after
    the add-LN."""

    def __init__(self, d_model, num_heads, dim_feedforward=None,
                 dropout=0.0, causal=True, use_flash_attention=None, *,
                 mp=1, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        _single_device(mp, "ParallelGPTBlock")
        ffn = dim_feedforward or 4 * d_model
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = int(d_model)
        self.dropout = float(dropout)
        self._generator = generator
        self.ln1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.attn = ParallelMultiHeadAttention(
            d_model, num_heads, dropout=dropout, causal=causal,
            use_flash_attention=use_flash_attention, **kw)
        self.ln2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.fc1 = ColumnParallelLinear(d_model, ffn, gather_output=False,
                                        **kw)
        self.fc2 = RowParallelLinear(ffn, d_model, input_is_parallel=True,
                                     **kw)

    def forward(self, x, cache=None, pos=None, adapter=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache, pos=pos)
        else:
            a, new_cache = self.attn(self.ln1(x)), None
        h, n2 = F.fused_residual_layer_norm(
            x, a, [self.d_model], self.ln2.weight, self.ln2.bias,
            self.ln2.epsilon)
        m = self.fc1(n2)
        if adapter is not None and "adapter_A" in self._buffers:
            # per-row LoRA delta on fc1 (serving.adapters.AdapterSet): rows
            # gathered from the resident stacks by the [B] id vector; row 0
            # is zeros, so id 0 adds exact zeros
            m = m + self._adapter_delta(n2, adapter)
        m = F.gelu(m)
        if self.dropout:
            m = F.dropout(m, self.dropout, training=self.training,
                          generator=self._generator)
        out = h + self.fc2(m)
        return out if new_cache is None else (out, new_cache)

    def _adapter_delta(self, x, ids):
        """``scale * B[a] @ (A[a] @ x)`` with ``a`` each row's adapter id:
        two batched low-rank products in float32 over the gathered rows,
        cast back to ``x``'s type."""
        ids = ids.to(torch.int64)
        a = self.adapter_A[ids].float()  # [B, r, d]
        b = self.adapter_B[ids].float()  # [B, ffn, r]
        u = torch.einsum("btd,brd->btr", x.float(), a)
        out = torch.einsum("btr,bfr->btf", u, b)
        return (self._adapter_scale * out).to(x.dtype)

    def gen_cache(self, batch_size, max_length, dtype=None,
                  block_size=None, pool_blocks=None):
        return self.attn.gen_cache(batch_size, max_length, dtype,
                                   block_size=block_size,
                                   pool_blocks=pool_blocks)
