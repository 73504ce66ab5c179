"""``MultiHeadAttention`` and ``TransformerEncoderLayer`` (counterparts of
``paddle_tpu/nn/layers/transformer.py``), on one device.

Attention takes the JAX package's ``attn_impl="dense"`` route: the routed
``functional.scaled_dot_product_attention`` (the flash kernel for causal,
mask-free, dropout-free attention; the dense form otherwise), or, with
``need_weights``, the dense form that returns the weights. The
``blockwise``, ``ring`` and ``ulysses`` routes, the paged and quantized KV
caches, and ``ParamAttr`` are not ported yet, and raise.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from .. import functional as F
from ..functional import attention as attn_route
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer"]


def _no_param_attr(what, weight_attr, bias_attr):
    if weight_attr is not None or bias_attr is not None:
        raise NotImplementedError(f"{what}: ParamAttr is not ported yet")


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = attend) -> an additive mask of 0 and -1e9."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, torch.zeros((), dtype=dtype,
                                              device=attn_mask.device),
                       torch.full((), -1e9, dtype=dtype,
                                  device=attn_mask.device))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with paddle's parameters: one fused ``[3d, d]``
    ``qkv_proj`` when ``kdim == vdim == embed_dim`` (the q, k and v
    projections are its row slices), else ``q_proj``/``k_proj``/
    ``v_proj``; then ``out_proj``. ``forward`` returns the output, plus the
    attention weights with ``need_weights`` and the updated cache when one
    is passed.

    ``Cache(k, v)`` holds a layer's ``[B, H, T, Dh]`` keys and values:
    concatenated with the new ones (``pos=None``), or, for a
    static-capacity cache, written in place at per-slot positions ``pos``
    and attended by position (``cached_attention``). ``StaticCache(k, v)``
    holds precomputed keys and values that are attended as they are."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, attn_impl="dense", causal=False,
                 block_size=512, *, device, dtype=torch.float32, generator):
        super().__init__()
        if attn_impl != "dense":
            raise NotImplementedError(
                f"MultiHeadAttention: attn_impl={attn_impl!r} is not ported "
                "yet (dense only)")
        _no_param_attr("MultiHeadAttention", weight_attr, bias_attr)
        self.attn_impl, self.causal = attn_impl, causal
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self._generator = generator
        kw = dict(device=device, dtype=dtype, generator=generator)
        self._fused_qkv = self.kdim == embed_dim and self.vdim == embed_dim
        if self._fused_qkv:
            self.qkv_proj = Linear(embed_dim, 3 * embed_dim, **kw)
        else:
            self.q_proj = Linear(embed_dim, embed_dim, **kw)
            self.k_proj = Linear(self.kdim, embed_dim, **kw)
            self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _proj(self, x, which):
        """Project with q, k or v (0, 1, 2): a row slice of the fused
        weight."""
        if not self._fused_qkv:
            return (self.q_proj, self.k_proj, self.v_proj)[which](x)
        d = self.embed_dim
        rows = slice(which * d, (which + 1) * d)
        return F.linear(x, self.qkv_proj.weight[rows],
                        self.qkv_proj.bias[rows])

    def _split_heads(self, x):
        B, T = int(x.shape[0]), int(x.shape[1])
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def gen_cache(self, key=None, value=None, type=None, max_length=None,
                  batch_size=None, dtype=None):
        """``StaticCache`` of ``key``/``value`` projected (``type=
        StaticCache``), else a ``Cache`` of zeros: ``[B, H, max_length,
        Dh]`` for static-capacity decoding, or of length 0 to concatenate
        onto."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self._proj(key, 1))
            v = self._split_heads(self._proj(
                value if value is not None else key, 2))
            return MultiHeadAttention.StaticCache(k, v)
        if batch_size is None and key is None:
            raise ValueError("gen_cache needs `key` or `batch_size`")
        B = int(batch_size if batch_size is not None else key.shape[0])
        w = self.out_proj.weight
        shape = (B, self.num_heads, int(max_length or 0), self.head_dim)
        return MultiHeadAttention.Cache(
            *(torch.zeros(shape, device=w.device, dtype=dtype or w.dtype)
              for _ in range(2)))

    def _finish_output(self, out, weights, cache):
        B, T = int(out.shape[0]), int(out.shape[2])
        out = self.out_proj(out.transpose(1, 2).reshape(B, T,
                                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None and not isinstance(
                cache, MultiHeadAttention.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, pos=None):
        key = query if key is None else key
        value = key if value is None else value
        static = isinstance(cache, MultiHeadAttention.StaticCache)
        k = v = None
        if self._fused_qkv and key is query and value is query \
                and not static:
            # self-attention: one [B, T, 3d] projection, split afterwards
            B, T = int(query.shape[0]), int(query.shape[1])
            qkv = self.qkv_proj(query).reshape(
                B, T, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
        else:
            q = self._split_heads(self._proj(query, 0))
        if static:
            k, v = cache.k, cache.v
        else:
            if k is None:
                k = self._split_heads(self._proj(key, 1))
                v = self._split_heads(self._proj(value, 2))
            if isinstance(cache, MultiHeadAttention.Cache):
                if pos is not None:
                    if attn_mask is not None or self.need_weights:
                        raise NotImplementedError(
                            "static-capacity decode is causal by position "
                            "and returns no weights")
                    k = attn_route.cache_update(cache.k, k, pos)
                    v = attn_route.cache_update(cache.v, v, pos)
                    out = attn_route.cached_attention(
                        q, k, v, pos, scale=self.head_dim ** -0.5)
                    return self._finish_output(
                        out, None, MultiHeadAttention.Cache(k, v))
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = MultiHeadAttention.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        if not self.need_weights:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=self.dropout,
                is_causal=self.causal, training=self.training,
                generator=self._generator)
            return self._finish_output(out, None, cache)
        drop = self.dropout if self.training else 0.0
        out, weights = attn_route.dense_attention(
            q, k, v, mask, self.causal, None, drop, self._generator)
        return self._finish_output(out, weights, cache)


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a two-layer MLP, each with dropout and a
    residual sum and a LayerNorm (post-LN by default; ``normalize_before``
    for pre-LN). The LayerNorms route to the B5/B7 kernels when eligible."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 attn_impl="dense", causal=False, *, device,
                 dtype=torch.float32, generator):
        super().__init__()
        _no_param_attr("TransformerEncoderLayer", weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            attn_impl=attn_impl,
                                            causal=causal, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)
