"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/meta_parallel.py``).

Reference: python/paddle/distributed/collective.py:492
(``_parallel_linear``), :526 (``_parallel_embedding``), :566 (``split``):
weight-partitioned layers over a model-parallel ring with explicit
all-reduce / all-gather calls (Megatron's).

The JAX package keeps each partitioned weight as one global array sharded
over the mesh's ``mp`` axis and lets XLA insert the collectives. On the
port's process model (``comm.py``) each rank keeps **its shard** and the
collectives are written out, as Megatron writes them, as autograd
Functions over ``collective.py``: an identity whose backward all-reduces
(:class:`_CopyToMP`) before a column-parallel product, an all-reduce whose
backward is the identity (:class:`_ReduceFromMP`) after a row-parallel one,
an all-gather of the last dim (``gather_output``) whose backward takes this
rank's part, and the part of an input that is not yet parallel
(``input_is_parallel=False``) whose backward all-gathers.

- ``ColumnParallelLinear``: ``weight`` ``[in, out/mp]`` (this rank's
  columns), ``bias`` ``[out/mp]``.
- ``RowParallelLinear``: ``weight`` ``[in/mp, out]`` (this rank's rows);
  the full ``bias`` is added after the all-reduce.
- ``VocabParallelEmbedding``: ``weight`` ``[vocab/mp, dim]`` (this rank's
  rows); ids outside them look up zeros, and the all-reduce sums the
  ranks' rows.
- ``ParallelMultiHeadAttention``: ``num_heads / mp`` heads a rank; the
  fused ``[d, 3d]`` qkv weight keeps, of each of q, k and v, the columns
  of this rank's heads, and the output projection their rows. Each rank
  runs the attention kernels (B1, B3, B4) on its ``[B, H/mp, S, D]``
  heads, and the LayerNorm kernels (B5, B6, B7) on its rows: no seam wraps
  a kernel.
- ``ParallelGPTBlock``: the pre-LN block of these.

A degree that does not divide its dimension raises ``ValueError``. ``mp``
(keyword) defaults to the hybrid mesh's mp degree (1 without a mesh); one
that differs from the mesh's raises. At mp = 1 every layer is the plain
single-device one. With ``PADDLE_TP_OVERLAP`` set on, the forward of a
``RowParallelLinear`` and of a gathering ``ColumnParallelLinear`` takes
the overlap ring (``overlap.row_parallel_overlap``,
``overlap.column_gather_overlap``) where ``overlap.row_overlap_plan``
allows it, and the plain form otherwise, as the JAX package's do.

**Weights.** ``state_dict()`` on a rank returns its **shards** (the local
parameters). ``set_state_dict`` takes either the shards or the **full**
arrays, as a ``paddle_tpu`` ``state_dict()`` gives them in the JAX layout,
and keeps this rank's part of a full one (``Layer.set_state_dict`` asks
each parameter's ``_tp_shard``). :func:`full_state_dict` gathers every
rank's shards back into the full arrays (a collective: every mp rank calls
it). The shards of a new layer draw from the ``shard_init`` stream (one
per mp index, ``comm._publish_streams``), so no two shards start equal.

Under AMP O1 the block's types flow as in the JAX package: the residual
stream stays float32, the projections (``linear``) and the attention
products run in bfloat16, and the residual sums come back float32. In a
world of several ranks, dropout draws from the rank's ``dropout_mp``
stream: per dp rank, and per mp rank too, since the heads and the MLP's
hidden activations are sharded by tensor parallelism (a layer built with
a ``generator`` keeps its own).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import amp
from ..core import random as rnd
from . import collective, comm, overlap
from . import quantized_comm as qc
from ..nn import functional as F
from ..nn.functional import attention as attn_route
from ..nn.initializer import XavierNormal
from ..nn.layer import Layer, ParamAttr
from ..nn.layers.common import Linear
from ..nn.layers.norm import LayerNorm
from ..nn.layers.transformer import MultiHeadAttention

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelMultiHeadAttention",
           "ParallelGPTBlock", "split", "full_state_dict",
           "global_square_sum", "norm_groups", "is_shard"]


def _mp_of(mp: Optional[int], what: str):
    """(mp degree, this rank's mp index, the mp Group or None)."""
    mesh = comm.hybrid_mesh()
    n = int(mesh.shape["mp"]) if mesh is not None else 1
    if mp is not None and int(mp) != n:
        raise ValueError(
            f"{what}: mp={mp}, but the hybrid mesh's mp degree is {n}: "
            "declare the mesh first (fleet.init with hybrid_configs, or "
            "distributed.comm.init_hybrid_mesh)")
    if n == 1:
        return 1, 0, None
    return n, mesh.axis_rank("mp"), mesh.group("mp")


def _divides(n: int, dim: int, name: str) -> None:
    if dim % n:
        raise ValueError(f"{name}={dim} not divisible by mp={n}")


class _Shard:
    """How a parameter splits over mp: along ``axis``, whose full length is
    ``groups`` blocks, each cut into ``n`` parts (this rank's is part
    ``rank`` of each block)."""

    def __init__(self, full_shape, axis: int, n: int, rank: int, group,
                 groups: int = 1):
        self.full_shape = tuple(int(s) for s in full_shape)
        self.axis, self.n, self.rank = axis, n, rank
        self.group, self.groups = group, groups

    def take(self, full: torch.Tensor) -> torch.Tensor:
        a = self.axis
        x = full.unflatten(a, (self.groups, self.n, -1))
        return x.select(a + 1, self.rank).flatten(a, a + 1)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every mp rank's ``local`` (a collective)."""
        parts = collective.all_gather_(local.detach().contiguous(),
                                       self.group)
        a = self.axis + 1
        x = parts.unflatten(a, (self.groups, -1)).movedim(0, a)
        return x.flatten(a - 1, a + 1)


def _redraw_shard(w, weight_attr, fan_in, fan_out, gen) -> None:
    """A default-initialized shard drawn again with Xavier's fans of the
    full ``[fan_in, fan_out]`` weight, from this rank's shard stream."""
    if getattr(ParamAttr._to_attr(weight_attr), "initializer",
               None) is not None:
        return
    with torch.no_grad():
        w.copy_(XavierNormal(fan_in, fan_out)(
            tuple(w.shape), w.dtype, device=w.device, generator=gen))


def _overlap_plan(x, weight):
    """The overlap ring's plan (``overlap.row_overlap_plan``) when
    ``PADDLE_TP_OVERLAP`` routes this layer's product through it, else
    None; None too when the weight takes a quantized-matmul route (scales
    attached, or an armed policy), whose narrow form goes through
    ``F.linear``, as in the JAX package."""
    if not overlap.tp_overlap_enabled():
        return None
    from . import quantized_compute as Q

    if Q.scale_of(weight) is not None or Q.matmul_policy() is not None:
        return None
    rows = 1
    for d in x.shape[:-1]:
        rows *= int(d)
    return overlap.row_overlap_plan(comm.hybrid_mesh(), rows)


def _mark(p, shard: _Shard):
    p._tp_shard = shard
    return p


def is_shard(p) -> bool:
    """Is ``p`` a tensor-parallel shard (upstream Paddle's
    ``is_distributed`` parameter)?"""
    return getattr(p, "_tp_shard", None) is not None


# -- Megatron's collectives as autograd Functions ---------------------------

class _CopyToMP(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over mp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce_(g.contiguous().clone(),
                                      group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward over mp; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return collective.all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather of the last dim (in ``groups`` blocks); the backward
    takes this rank's part."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.take(g).contiguous(), None


class _ScatterToMP(torch.autograd.Function):
    """This rank's part of the last dim; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.take(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g.contiguous()), None


class ColumnParallelLinear(Linear):
    """Column-partitioned linear (collective.py:492, axis=1): ``weight``
    ``[in, out/mp]`` on each rank. ``gather_output=True`` all-gathers the
    output's features; False leaves them split for a following
    ``RowParallelLinear``. ``has_bias=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, bias_attr=None,
                 name=None, *, mp=None, device=None, dtype=None,
                 generator=None, _col_groups=1):
        n, r, g = _mp_of(mp, "ColumnParallelLinear")
        _divides(n * _col_groups, out_features, "out_features")
        gen = generator if generator is not None or n == 1 else \
            rnd.stream_generator("shard_init", comm.rank_device(device))
        super().__init__(in_features, out_features // n, weight_attr,
                         bias_attr if has_bias else False, device=device,
                         dtype=dtype, generator=gen)
        self.gather_output = bool(gather_output)
        self._mp, self._mp_rank, self._mp_group = n, r, g
        self._col_groups = _col_groups
        if n > 1:
            _redraw_shard(self.weight, weight_attr, in_features,
                          out_features, gen)
            _mark(self.weight, _Shard((in_features, out_features), 1, n, r,
                                      g, _col_groups))
            if self.bias is not None:
                _mark(self.bias, _Shard((out_features,), 0, n, r, g,
                                        _col_groups))

    def forward(self, x):
        if self._mp == 1:
            return super().forward(x)
        if self.gather_output and self._col_groups == 1 \
                and _overlap_plan(x, self.weight) is not None:
            return overlap.column_gather_overlap(x, self.weight, self.bias,
                                                 self._mp_group)
        out = F.linear(_CopyToMP.apply(x, self._mp_group), self.weight,
                       self.bias)
        if self.gather_output:
            return _GatherFromMP.apply(out, _Shard(
                (), out.dim() - 1, self._mp, self._mp_rank, self._mp_group,
                self._col_groups))
        return out


class RowParallelLinear(Linear):
    """Row-partitioned linear (collective.py:492, axis=0): ``weight``
    ``[in/mp, out]`` on each rank; the partial products are all-reduced
    and the full ``bias`` added. ``input_is_parallel=False`` takes this
    rank's part of a full input first. ``has_bias=False`` drops the
    bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, bias_attr=None,
                 name=None, *, mp=None, device=None, dtype=None,
                 generator=None):
        n, r, g = _mp_of(mp, "RowParallelLinear")
        _divides(n, in_features, "in_features")
        gen = generator if generator is not None or n == 1 else \
            rnd.stream_generator("shard_init", comm.rank_device(device))
        super().__init__(in_features // n, out_features, weight_attr,
                         bias_attr if has_bias else False, device=device,
                         dtype=dtype, generator=gen)
        self.input_is_parallel = bool(input_is_parallel)
        self._mp, self._mp_rank, self._mp_group = n, r, g
        if n > 1:
            _redraw_shard(self.weight, weight_attr, in_features,
                          out_features, gen)
            _mark(self.weight, _Shard((in_features, out_features), 0, n, r,
                                      g))

    def forward(self, x):
        if self._mp == 1:
            return super().forward(x)
        if not self.input_is_parallel:
            x = _ScatterToMP.apply(x, _Shard(
                (), x.dim() - 1, self._mp, self._mp_rank, self._mp_group))
        if _overlap_plan(x, self.weight) is not None:
            return overlap.row_parallel_overlap(x, self.weight, self.bias,
                                                self._mp_group)
        out = _ReduceFromMP.apply(F.linear(x, self.weight), self._mp_group)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class VocabParallelEmbedding(Layer):
    """Vocab-partitioned embedding (collective.py:526): ``weight``
    ``[vocab/mp, dim]`` on each rank, rows ``[r * vocab/mp, (r + 1) *
    vocab/mp)``. Each rank looks up the ids in its rows (zeros elsewhere)
    and the all-reduce sums the ranks' rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, *, mp=None, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        n, r, g = _mp_of(mp, "VocabParallelEmbedding")
        _divides(n, num_embeddings, "num_embeddings")
        gen = generator if generator is not None or n == 1 else \
            rnd.stream_generator("shard_init", comm.rank_device(device))
        self._mp, self._mp_rank, self._mp_group = n, r, g
        self._rows = num_embeddings // n
        self.weight = self.create_parameter(
            [self._rows, embedding_dim], weight_attr,
            default_initializer=XavierNormal(num_embeddings, embedding_dim),
            device=device, generator=gen)
        if n > 1:
            _mark(self.weight, _Shard((num_embeddings, embedding_dim), 0,
                                      n, r, g))

    def forward(self, x):
        if self._mp == 1:
            return F.embedding(x, self.weight)
        ids = x.long() - self._mp_rank * self._rows
        outside = (ids < 0) | (ids >= self._rows)
        out = F.embedding(ids.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return _ReduceFromMP.apply(out, self._mp_group)


class ParallelMultiHeadAttention(Layer):
    """Self-attention (causal unless ``causal=False``) with a fused ``[d,
    3d]`` qkv projection, ``num_heads / mp`` heads a rank.

    Full forward: the flash kernel when ``use_flash_attention`` is True,
    or when it is None (the default) and ``flash_plan`` routes it (the
    flash-by-default policy of ``PADDLE_FLASH_DEFAULT``, which declines
    while attention dropout is active, and, in a world of several ranks,
    under ``PADDLE_FLASH_SHARD=0``); else, and always with
    ``use_flash_attention=False``, the dense form: scores (``matmul``), a
    ``triu(-1e9)`` mask when causal, ``softmax``, dropout, then the
    context product (``matmul``). Cached forward (serving): write this
    step's K/V at per-slot ``pos`` first, then attend over the whole
    capacity with the position mask (``cached_attention``)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, causal=True,
                 weight_attr=None, bias_attr=None, use_flash_attention=None,
                 *, mp=None, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        n, _, _ = _mp_of(mp, "ParallelMultiHeadAttention")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide into num_heads")
        _divides(n, num_heads, "num_heads")
        if use_flash_attention and dropout:
            raise ValueError(
                "use_flash_attention requires dropout=0.0: the flash "
                "kernel never materializes the attention probabilities")
        self.num_heads = int(num_heads)
        self._local_heads = self.num_heads // n
        self.head_dim = embed_dim // num_heads
        self.causal = bool(causal)
        self.dropout = float(dropout)
        self.use_flash_attention = use_flash_attention
        self._generator = generator
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.qkv = ColumnParallelLinear(
            embed_dim, 3 * embed_dim, weight_attr, bias_attr=bias_attr,
            gather_output=False, _col_groups=3, **kw)
        self.out_proj = RowParallelLinear(
            embed_dim, embed_dim, weight_attr, bias_attr=bias_attr,
            input_is_parallel=True, **kw)

    def gen_cache(self, batch_size, max_length, dtype=None,
                  block_size=None, pool_blocks=None):
        """Zero ``[B, H, cap, Dh]`` K/V buffers (this rank's heads) in the
        layer's dtype; or, with ``block_size`` (the
        ``PADDLE_SERVE_BLOCK_SIZE`` default when not given; an explicit
        value wins), a paged cache: a ``[P, H, bs, Dh]`` block pool and a
        ``[B, nmax]`` table per K and V (``serving.paged_kv.PagedKV``), the
        capacity rounded up to whole blocks. ``pool_blocks`` sizes the pool
        (tables start all-trash); without it the tables are
        identity-mapped. ``dtype="int8"`` or ``"fp8"`` (the
        ``PADDLE_SERVE_KV_QUANT`` default when not given) makes either form
        block-quantized (``QuantKV``: the narrow payload at the cache's
        shape, float32 scales per block of the head dim)."""
        from ..serving import paged_kv as pk  # serving imports this module

        kvq = qc.kv_quant_policy(dtype)
        dev = self.qkv.weight.device
        # a narrow weight has no float type: the bias's is the cache's
        b = self.qkv.bias
        dt = dtype or (b.dtype if b is not None else self._dtype)
        H = self._local_heads
        bs = (int(block_size) if block_size is not None
              else pk.block_size_default())
        if bs > 0:
            return MultiHeadAttention.Cache(*(pk.paged_zero(
                batch_size, H, max_length, self.head_dim,
                block=bs, pool_blocks=pool_blocks,
                dtype=None if kvq else dt, quant=kvq, device=dev)
                for _ in range(2)))
        shape = (int(batch_size), H, int(max_length), self.head_dim)
        if kvq is not None:
            return MultiHeadAttention.Cache(
                *(qc.kv_zero(shape, kvq, device=dev) for _ in range(2)))
        return MultiHeadAttention.Cache(
            torch.zeros(shape, device=dev, dtype=dt),
            torch.zeros(shape, device=dev, dtype=dt))

    def forward(self, x, cache=None, pos=None):
        B, T = int(x.shape[0]), int(x.shape[1])
        H, dh = self._local_heads, self.head_dim
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
        elif route:
            # forced: still dense where PADDLE_FLASH_SHARD=0 declines a
            # job of several ranks, as the JAX package's seam does
            route = attn_route.shard_route_allowed("flash")
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
                             generator=self._generator,
                             stream="dropout_mp")
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
    the add-LN (mp = 1)."""

    def __init__(self, d_model, num_heads, dim_feedforward=None,
                 dropout=0.0, causal=True, use_flash_attention=None, *,
                 mp=None, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        n, _, _ = _mp_of(mp, "ParallelGPTBlock")
        ffn = dim_feedforward or 4 * d_model
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = int(d_model)
        self.dropout = float(dropout)
        self._generator = generator
        self.ln1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.attn = ParallelMultiHeadAttention(
            d_model, num_heads, dropout=dropout, causal=causal,
            use_flash_attention=use_flash_attention, mp=n, **kw)
        self.ln2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.fc1 = ColumnParallelLinear(d_model, ffn, gather_output=False,
                                        mp=n, **kw)
        self.fc2 = RowParallelLinear(ffn, d_model, input_is_parallel=True,
                                     mp=n, **kw)

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
                          generator=self._generator, stream="dropout_mp")
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


def split(x, size, operation: str, axis: int = 0,
          num_partitions: Optional[int] = None, gather_out: bool = True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split (collective.py:566): build a model-parallel
    layer and apply it. ``size=(in, out)`` for ``"linear"`` (axis 0 row-,
    axis 1 column-parallel), ``(vocab, dim)`` for ``"embedding"``. Makes
    new parameters at each call: build the layers themselves inside
    models. ``num_partitions``, when given, must be the mesh's mp."""
    if operation == "linear":
        if axis == 1:
            layer = ColumnParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                bias_attr=bias_attr, gather_output=gather_out,
                mp=num_partitions)
        elif axis == 0:
            layer = RowParallelLinear(
                size[0], size[1], weight_attr=weight_attr,
                bias_attr=bias_attr, input_is_parallel=not gather_out,
                mp=num_partitions)
        else:
            raise ValueError("split(linear) axis must be 0 or 1")
    elif operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr,
                                       mp=num_partitions)
    else:
        raise ValueError(f"unknown split operation {operation!r}")
    return layer(x)


def full_state_dict(layer: Layer) -> Dict[str, np.ndarray]:
    """``layer``'s state with every shard gathered back to its full array,
    as numpy arrays in the JAX package's layout: a parameter held as its
    ZeRO stage-3 shard over dp first (its logical shape, the padding
    cut), then each tensor-parallel shard over mp (a collective: every
    rank of those groups calls it)."""
    out = {}
    for name, t in layer.state_dict(keep_vars=True).items():
        zs = getattr(t, "_zero_shard", None)
        full = zs.gather(t) if zs is not None and tuple(t.shape) == \
            zs.shard_shape else t.detach()
        shard = getattr(t, "_tp_shard", None)
        full = shard.gather(full) if shard is not None else full
        out[name] = full.float().cpu().numpy() \
            if full.dtype == torch.bfloat16 else full.cpu().numpy()
    return out


def norm_groups(p, t) -> tuple:
    """The groups over which the squares of ``t``, a value of parameter
    ``p`` (or its gradient, or an update of it), are summed to give the
    full tensor's: the ZeRO group when ``t`` is this rank's ZeRO shard of
    ``p`` (``p._zero_shard``, ``distributed.fleet``), then the mp group
    when ``p`` is a tensor-parallel shard; ``()`` for a replicated
    tensor."""
    out = []
    zs = getattr(p, "_zero_shard", None)
    if zs is not None and tuple(t.shape) == zs.shard_shape:
        out.append(zs.group)
    shard = getattr(p, "_tp_shard", None)
    if shard is not None and shard.group is not None \
            and shard.group.nranks > 1:
        out.append(shard.group)
    return tuple(out)


def global_square_sum(params_grads) -> torch.Tensor:
    """The squared L2 norm, in float32, of the full gradients of
    ``(param, grad)`` pairs (None gradients skipped): the replicated ones
    counted once, the shards (tensor-parallel, :func:`is_shard`, and ZeRO
    shards, :func:`norm_groups`) summed over their groups, as the JAX
    package's global arrays give it. A 0-dim tensor on the gradients'
    device, equal on every rank of those groups."""
    by_groups = {}
    for p, g in params_grads:
        if g is not None:
            gs = norm_groups(p, g)
            by_groups.setdefault(tuple(id(x) for x in gs), (gs, []))[1] \
                .append(g)
    total = None
    for gs, grads in by_groups.values():
        sq = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)
                         ).square().sum()
        for g in gs:
            sq = collective.all_reduce_(sq.reshape(1).clone(),
                                        group=g).reshape(())
        total = sq if total is None else total + sq
    return total
