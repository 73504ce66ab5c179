"""Attention routing and the static-capacity KV cache.

Counterpart of ``paddle_tpu/nn/functional/attention.py`` on one device:
the flash-by-default policy (``flash_plan``) with the JAX package's
decline rules, the kernel call (``flash_core``, through the autograd
Function whose backward runs the B3/B4 kernels), the dense
``scaled_dot_product_attention``, and the serving cache ops
``cache_update`` / ``cached_attention`` over a contiguous or a paged
(``serving.paged_kv.PagedKV``) cache, full width or int8/fp8
(``distributed.quantized_comm.QuantKV``), which stay plain PyTorch as the
JAX package leaves them to XLA.

Knobs, with the JAX package's meanings: ``PADDLE_FLASH_DEFAULT=0`` keeps
the dense path everywhere; ``=interpret`` routes on the CPU too, where the
kernel wrapper runs its plain version. ``PADDLE_FLASH_APPEND=0`` sends
every Sq != Sk shape to the dense end-aligned form.
"""
from __future__ import annotations

import os

import torch

from ... import amp
from ...distributed import quantized_comm as qc
from ...ops.kernels.flash_attention import FlashAttentionFunction
from .common import dropout

__all__ = [
    "flash_default_enabled", "flash_append_enabled", "flash_plan",
    "flash_routable", "flash_core", "scaled_dot_product_attention", "dense_attention",
    "cache_update", "cached_attention",
]


def flash_default_enabled() -> bool:
    v = os.environ.get("PADDLE_FLASH_DEFAULT", "1").strip().lower()
    return v not in ("0", "false", "off")


def flash_append_enabled() -> bool:
    v = os.environ.get("PADDLE_FLASH_APPEND", "1").strip().lower()
    return v not in ("0", "false", "off")


def _interpret_forced() -> bool:
    return os.environ.get(
        "PADDLE_FLASH_DEFAULT", "").strip().lower() == "interpret"


def _flash_block(s: int) -> int:
    """Largest power-of-two tile <= 256 dividing s (kernel contract:
    S % block == 0)."""
    b = 256
    while b > 1 and s % b:
        b //= 2
    return b


def flash_plan(seq_q, seq_k, *, causal, device, has_mask=False,
               dropout_active=False, need_weights=False,
               has_cache=False) -> bool:
    """Does this attention go to the flash kernel? The JAX package's
    decline rules: not causal, a mask, active dropout, returned weights or
    a cache; Sq > Sk (or Sq != Sk with ``PADDLE_FLASH_APPEND=0``); a tile
    under 8 rows. "Backend has the kernel" is a CUDA ``device``; on the
    CPU only ``PADDLE_FLASH_DEFAULT=interpret`` routes."""
    if not flash_default_enabled():
        return False
    if not causal or has_mask or dropout_active or need_weights \
            or has_cache:
        return False
    if int(seq_q) != int(seq_k):
        if int(seq_q) > int(seq_k) or not flash_append_enabled():
            return False
    if torch.device(device).type != "cuda" and not _interpret_forced():
        return False
    return _flash_block(int(seq_q)) >= 8 and _flash_block(int(seq_k)) >= 8


def flash_routable(seq_q, seq_k, *, causal, has_mask=False,
                   dropout_active=False, need_weights=False,
                   has_cache=False, mesh=None, batch=None,
                   heads=None) -> bool:
    """Would the default router send this attention to the flash kernel
    on the ``set_device`` default device? The JAX package's signature;
    ``batch`` and ``heads`` only matter to its sharded route, and a
    ``mesh`` (more than one device) is ROADMAP queue A item 7."""
    if mesh is not None:
        raise NotImplementedError("flash_routable(mesh=): multi-device "
                                  "routing is ROADMAP queue A item 7")
    from ...core.device import resolve_device

    return flash_plan(seq_q, seq_k, causal=causal, device=resolve_device(),
                      has_mask=has_mask, dropout_active=dropout_active,
                      need_weights=need_weights, has_cache=has_cache)


def flash_core(q, k, v, *, causal=True, scale=None, q_offset=0):
    """Flash attention on ``[B, H, S, D]`` tensors through
    :class:`FlashAttentionFunction` (differentiable on both devices), tiles
    derived from the sequence lengths; ``q_offset`` is the global position
    of the first query row (``Sk - Sq`` for the end-aligned decode-append
    shape). Under AMP q, k and v are cast to the AMP type first
    (``flash_attention`` is white-listed); lse stays float32."""
    q, k, v = amp.cast_if_amp("flash_attention", (q, k, v))
    return FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        _flash_block(int(q.shape[2])), _flash_block(int(k.shape[2])), scale,
        q_offset, 0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None, *,
                                 generator=None):
    """Routed softmax attention over ``[B, H, S, D]``: the flash kernel for
    the causal, mask-free, dropout-free case; otherwise the dense form with
    the scores materialized, whose causal mask is end-aligned (``qpos =
    arange(Sq) + Sk - Sq``) so both routes compute one function. The dense
    form's two steps are the AMP names ``attention_scores`` (scores and
    softmax; the softmax runs in the type the scores come in, as in the
    JAX package) and ``attention_context`` (weights times V), with dropout
    of the weights between them in training (its mask drawn from
    ``generator``)."""
    Sq, Sk = int(query.shape[2]), int(key.shape[2])
    dropout_active = bool(dropout_p) and training
    if flash_plan(Sq, Sk, causal=is_causal, device=query.device,
                  has_mask=attn_mask is not None,
                  dropout_active=dropout_active):
        return flash_core(query, key, value, causal=is_causal, scale=scale,
                          q_offset=Sk - Sq)
    return dense_attention(query, key, value, attn_mask, is_causal, scale,
                           dropout_p if dropout_active else 0.0,
                           generator)[0]


def dense_attention(query, key, value, attn_mask=None, is_causal=False,
                    scale=None, dropout_p=0.0, generator=None):
    """The dense form of :func:`scaled_dot_product_attention` -> (out,
    weights): ``attention_scores`` (the scores plus ``attn_mask``, the
    end-aligned causal mask at -1e9, softmax), dropout of the weights when
    ``dropout_p`` (training), then ``attention_context``."""
    Sq, Sk = int(query.shape[2]), int(key.shape[2])
    sc = scale if scale is not None else int(query.shape[-1]) ** -0.5
    qr, kr, mr = amp.cast_if_amp("attention_scores",
                                 (query, key, attn_mask))
    s = torch.matmul(qr, kr.transpose(-1, -2)) * sc
    if mr is not None:
        s = s + mr
    if is_causal:
        qpos = torch.arange(Sq, device=query.device) + (Sk - Sq)
        kpos = torch.arange(Sk, device=query.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e9)
    w = torch.softmax(s, dim=-1)
    if dropout_p:
        w = dropout(w, dropout_p, training=True, generator=generator)
    wr, vr = amp.cast_if_amp("attention_context", (w, value))
    return torch.matmul(wr, vr), w


def _write_rows(buf, rows, pos):
    """Write ``rows`` ``[B, H, Sq, *]`` into ``buf`` ``[B, H, cap, *]`` at
    per-slot positions ``pos``, in place, the start clamped to ``cap -
    Sq`` (dynamic_update_slice's rule); float8 through its bytes."""
    B, H, Sq, D = rows.shape
    cap = buf.shape[2]
    start = pos.to(torch.int64).clamp(0, cap - Sq)
    idx = start[:, None] + torch.arange(Sq, device=buf.device)
    qc.bits(buf).scatter_(2, idx[:, None, :, None].expand(B, H, Sq, D),
                          qc.bits(rows.to(buf.dtype)))


def cache_update(cache, new, pos):
    """Write the ``[B, H, Sq, D]`` rows ``new`` into the static-capacity
    ``[B, H, cap, D]`` cache at per-slot positions ``pos`` ([B] int), IN
    PLACE (the JAX package's donated dynamic_update_slice; updating in
    place keeps one cache buffer alive). Like dynamic_update_slice, a
    start that would run past the end is clamped to ``cap - Sq``. Returns
    ``cache``. No device-to-host read.

    A quantized cache (``QuantKV``: an int8/fp8 payload at the cache's
    shape and float32 scales per block of the head dim) quantizes the new
    rows along the head dim and writes payload and scales at the same
    positions. A paged cache (``PagedKV``) takes the same append through
    its block table, one scatter into the pool (``paged_write``), and
    composes with the quantized form."""
    from ...serving import paged_kv as pk  # serving imports this module

    if isinstance(cache, pk.PagedKV):
        return pk.PagedKV(pk.paged_write(cache.kv, cache.table, new, pos),
                          cache.table)
    if isinstance(cache, qc.QuantKV):
        uq, us = qc.quantize_like(cache, new)
        _write_rows(cache.q, uq, pos)
        _write_rows(cache.scale, us, pos)
        return cache
    _write_rows(cache, new, pos)
    return cache


def cached_attention(query, key, value, pos, *, scale=None):
    """Decode attention over a static-capacity cache: ``[B, H, Sq, D]``
    queries whose first row sits at per-slot position ``pos`` against
    ``[B, H, cap, D]`` cache K/V. The mask compares positions (``kpos >
    pos[b] + i`` gets -1e9), which also hides every row not yet written
    for this request. Dense on purpose, as in the JAX package: decode's
    Sq is 1 and the per-slot offset is a tensor, not a static seam. No AMP
    cast: the JAX package runs it outside its op dispatcher too.

    Paged K/V (``PagedKV``) are first gathered through their block tables
    into ``[B, H, nmax*bs, D]`` views (one gather each); their unwritten
    and trash-mapped rows sit at ``kpos > qpos``, where the same mask
    hides them. Quantized K/V (``QuantKV``, contiguous or pooled) are
    dequantized to the query's type on the read."""
    from ...serving import paged_kv as pk  # serving imports this module

    if isinstance(key, pk.PagedKV):
        # a quantized pool gathers narrow, then dequantizes the view
        dt = query.dtype if isinstance(key.kv, qc.QuantKV) else None
        key = pk.paged_gather(key.kv, key.table, dt)
        value = pk.paged_gather(value.kv, value.table, dt)
    elif isinstance(key, qc.QuantKV):
        key = qc.dequantize_lastaxis(key.q, key.scale, query.dtype)
        value = qc.dequantize_lastaxis(value.q, value.scale, query.dtype)
    sc = scale if scale is not None else int(query.shape[-1]) ** -0.5
    Sq, Sk = int(query.shape[2]), int(key.shape[2])
    s = torch.matmul(query, key.transpose(-1, -2)) * sc
    qpos = pos.to(torch.int64)[:, None] + torch.arange(
        Sq, device=query.device)[None, :]
    kpos = torch.arange(Sk, device=query.device)
    masked = kpos[None, None, None, :] > qpos[:, None, :, None]
    s = s.masked_fill(masked, -1e9)
    return torch.matmul(torch.softmax(s, dim=-1), value)
