"""``MultiHeadAttention``, the encoder and decoder layers and stacks, and
``Transformer`` (counterparts of ``paddle_tpu/nn/layers/transformer.py``),
on one device.

Attention takes the JAX package's ``attn_impl="dense"`` route by default:
the routed ``functional.scaled_dot_product_attention`` (the flash kernel
for causal, mask-free, dropout-free attention; the dense form otherwise),
or, with ``need_weights``, the dense form that returns the weights.
``attn_impl="blockwise"`` runs ``ring_attention.blockwise_attention``
(the flash kernels for block-divisible shapes on the card, causal or not)
and refuses, as the JAX package does, an ``attn_mask``, weight dropout in
training, ``need_weights`` and a cache. The sequence-parallel routes
``ring``, ``ring_pallas`` (each step on the flash kernels) and
``ulysses`` refuse the same; on a world with an ``sp`` axis each rank
passes its own sequence shard ``[B, S/sp, d]`` (global positions from
``sp_rank * S/sp``) and gets its rows back (``ring_attention_raw`` and
``_ulysses_raw`` over the mesh's sp group: a rank is a process, where the
JAX package's layer takes the global tensors); without a mesh they raise,
as there. ``gen_cache`` builds the static-capacity cache
contiguous or paged, full width or int8/fp8 (``QuantKV``).

``TransformerEncoder`` and ``TransformerDecoder`` clone their first layer
with ``copy.deepcopy``, as the JAX package does, so every layer starts
from the same weights; a generator the layer draws dropout masks from is
shared by the clones, not copied (a copy would repeat its masks).
``Transformer`` is post-LN Transformer-base at its defaults (d_model 512,
8 heads, 6 + 6 layers, ffn 2048, dropout 0.1, ReLU); its decoder's
``gen_cache(memory)`` gives each layer an incremental ``Cache`` for its
self-attention and a ``StaticCache`` of the memory's keys and values for
its cross-attention. Its LayerNorms route to the B5/B7 kernels when
eligible; a ``tgt_mask`` tensor (not ``causal``) and active dropout keep
its attention on the dense route, as in the JAX package.
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core.tensor import tensor_boundary
from .. import functional as F
from ..functional import attention as attn_route
from ..layer import Layer
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm
from .ring_attention import (_ulysses_raw, blockwise_attention,
                             ring_attention_raw)

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = attend) -> an additive mask of 0 and -1e9."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, torch.zeros((), dtype=dtype,
                                              device=attn_mask.device),
                       torch.full((), -1e9, dtype=dtype,
                                  device=attn_mask.device))


class MultiHeadAttention(Layer):
    """Multi-head attention with paddle's parameters: one fused ``[d, 3d]``
    ``qkv_proj`` when ``kdim == vdim == embed_dim`` (the q, k and v
    projections are its column slices), else ``q_proj``/``k_proj``/
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
                 block_size=512, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        if attn_impl not in ("dense", "blockwise", "ring", "ring_pallas",
                             "ulysses"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.attn_impl, self.causal = attn_impl, causal
        self.block_size = block_size
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
        attrs = (weight_attr, bias_attr)
        self._fused_qkv = self.kdim == embed_dim and self.vdim == embed_dim
        if self._fused_qkv:
            self.qkv_proj = Linear(embed_dim, 3 * embed_dim, *attrs, **kw)
        else:
            self.q_proj = Linear(embed_dim, embed_dim, *attrs, **kw)
            self.k_proj = Linear(self.kdim, embed_dim, *attrs, **kw)
            self.v_proj = Linear(self.vdim, embed_dim, *attrs, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, *attrs, **kw)

    def _proj(self, x, which):
        """Project with q, k or v (0, 1, 2): a column slice of the fused
        weight."""
        if not self._fused_qkv:
            return (self.q_proj, self.k_proj, self.v_proj)[which](x)
        d = self.embed_dim
        cols = slice(which * d, (which + 1) * d)
        b = self.qkv_proj.bias
        return F.linear(x, self.qkv_proj.weight[:, cols],
                        None if b is None else b[cols])

    def _split_heads(self, x):
        B, T = int(x.shape[0]), int(x.shape[1])
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    @tensor_boundary
    def gen_cache(self, key=None, value=None, type=None, max_length=None,
                  batch_size=None, dtype=None, block_size=None,
                  pool_blocks=None):
        """``StaticCache`` of ``key``/``value`` projected (``type=
        StaticCache``), else a ``Cache`` of zeros: ``[B, H, max_length,
        Dh]`` for static-capacity decoding, or of length 0 to concatenate
        onto. With ``block_size`` (or, for the static-capacity form, the
        ``PADDLE_SERVE_BLOCK_SIZE`` default) the static-capacity cache is
        paged (``serving.paged_kv.PagedKV``; ``pool_blocks`` as in
        ``ParallelMultiHeadAttention.gen_cache``). ``dtype="int8"`` or
        ``"fp8"`` (or, for the static-capacity form, the
        ``PADDLE_SERVE_KV_QUANT`` default) makes it block-quantized
        (``QuantKV``); without ``max_length`` that raises, and a
        concatenating caller that asked for no dtype keeps its float
        cache."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self._proj(key, 1))
            v = self._split_heads(self._proj(
                value if value is not None else key, 2))
            return MultiHeadAttention.StaticCache(k, v)
        if batch_size is None and key is None:
            raise ValueError("gen_cache needs `key` or `batch_size`")
        B = int(batch_size if batch_size is not None else key.shape[0])
        from ...distributed import quantized_comm as qc
        from ...serving import paged_kv as pk  # serving imports this module

        cap = int(max_length or 0)
        kvq = qc.kv_quant_policy(dtype)
        if kvq is not None and not cap and dtype is None:
            kvq = None  # the env default is for the serving form only
        # a narrow weight has no float type: the bias's is the cache's
        b = self.out_proj.bias
        dev = self.out_proj.weight.device
        dt = b.dtype if b is not None else self._dtype
        bs = (int(block_size) if block_size is not None
              else (pk.block_size_default() if cap else 0))
        if bs > 0:
            if not cap:
                raise ValueError("a paged KV cache needs the static-capacity "
                                 "form: pass max_length=")
            return MultiHeadAttention.Cache(*(pk.paged_zero(
                B, self.num_heads, cap, self.head_dim, block=bs,
                pool_blocks=pool_blocks, dtype=None if kvq else dtype or dt,
                quant=kvq, device=dev) for _ in range(2)))
        shape = (B, self.num_heads, cap, self.head_dim)
        if kvq is not None:
            if not cap:
                raise ValueError("a quantized KV cache needs the "
                                 "static-capacity form: pass max_length=")
            return MultiHeadAttention.Cache(
                *(qc.kv_zero(shape, kvq, device=dev) for _ in range(2)))
        return MultiHeadAttention.Cache(
            *(torch.zeros(shape, device=dev, dtype=dtype or dt)
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

    def _refuse_blockwise(self, attn_mask, cache, pos):
        """What the blockwise route does not compute, refused as the JAX
        package refuses it: it never forms the weights and masks by local
        query positions."""
        if cache is not None and pos is not None:
            raise NotImplementedError(
                "static-capacity decode requires attn_impl='dense' "
                "(blockwise/ring paths have no traced-position masking)")
        if attn_mask is not None:
            raise NotImplementedError(
                "blockwise/ring attention support causal=True masking only; "
                "arbitrary attn_mask needs the dense impl")
        if self.dropout and self.training:
            raise NotImplementedError(
                "attention-weight dropout requires the dense impl "
                "(flash-style paths never materialize the weights)")
        if self.need_weights:
            raise NotImplementedError("need_weights requires the dense impl")
        if cache is not None:
            raise NotImplementedError(
                "incremental-decode Cache needs query-position offsets the "
                "blockwise/ring paths do not implement yet; use the dense "
                "impl for decoding")

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, pos=None):
        if self.attn_impl != "dense":
            self._refuse_blockwise(attn_mask, cache, pos)
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
        if self.attn_impl == "blockwise":
            out = blockwise_attention(q, k, v, causal=self.causal,
                                      block_size=self.block_size)
            return self._finish_output(out, None, cache)
        if self.attn_impl == "ulysses":
            out = _ulysses_raw(q, k, v, causal=self.causal,
                               block_size=self.block_size)
            return self._finish_output(out, None, cache)
        if self.attn_impl in ("ring", "ring_pallas"):
            out = ring_attention_raw(
                q, k, v, causal=self.causal,
                use_pallas=self.attn_impl == "ring_pallas")
            return self._finish_output(out, None, cache)
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


class TransformerEncoderLayer(Layer):
    """Self-attention then a two-layer MLP, each with dropout and a
    residual sum and a LayerNorm (post-LN by default; ``normalize_before``
    for pre-LN). The LayerNorms route to the B5/B7 kernels when eligible."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 attn_impl="dense", causal=False, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        attrs = (weight_attr, bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr,
                                            attn_impl=attn_impl,
                                            causal=causal, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **kw)
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

    @tensor_boundary
    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, n):
    """``layer`` and ``n - 1`` deep copies of it that share its
    generators."""
    memo = {id(v): v for m in layer.modules() for v in vars(m).values()
            if isinstance(v, torch.Generator)}
    return LayerList([layer] + [copy.deepcopy(layer, dict(memo))
                                for _ in range(n - 1)])


class TransformerEncoder(Layer):
    """``num_layers`` encoder layers (``encoder_layer`` and its clones),
    then ``norm`` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    @tensor_boundary
    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention (``tgt_mask``), cross-attention over ``memory``
    (``memory_mask``), then a two-layer MLP, each with dropout, a residual
    sum and a LayerNorm (post-LN by default). With ``cache`` (``(Cache,
    StaticCache)`` from :meth:`gen_cache`) the self-attention appends to
    its cache and the cross-attention reads the memory's projected keys
    and values; returns ``(out, new cache)``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        attrs = (weight_attr, bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    @tensor_boundary
    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers (``decoder_layer`` and its clones),
    then ``norm`` when given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    @tensor_boundary
    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """Encoder-decoder Transformer (Transformer-base at its defaults);
    ``forward(src, tgt, src_mask, tgt_mask, memory_mask)`` returns the
    decoder's output ``[B, T, d_model]``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        kw = dict(device=device, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)

        def final_norm():
            return LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None

        self.encoder = custom_encoder if custom_encoder is not None else \
            TransformerEncoder(TransformerEncoderLayer(*args, **kw),
                               num_encoder_layers, final_norm())
        self.decoder = custom_decoder if custom_decoder is not None else \
            TransformerDecoder(TransformerDecoderLayer(*args, **kw),
                               num_decoder_layers, final_norm())
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` float32: 0 on and below the diagonal, -1e9
        above it (the JAX package's value, not -inf), on the
        ``set_device`` default device. Returns a ``Tensor``."""
        from ...core.device import resolve_device
        from ...core.tensor import Tensor

        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device()).tril()
        return Tensor._wrap(torch.where(keep, 0.0, -1e9).to(torch.float32))
