"""The causal LM of ``paddle_tpu/serving/model.py``, with the serving
model contract the decode steps consume::

    model(ids)                       -> [B, S, V] logits (full forward)
    model(ids, cache=cs, pos=pos[, adapter=ids])
                                     -> ([B, Sq, V] logits, new caches)
    model.gen_cache(B, cap[, dtype, block_size=, pool_blocks=])
                                     -> per-layer static-capacity caches
                                        (contiguous or paged; float, or
                                        int8/fp8 with dtype="int8"/"fp8"
                                        or PADDLE_SERVE_KV_QUANT)
    model.load_quantized(path)       -> an int8/fp8 weight checkpoint,
                                        loaded narrow

Token + learned position embeddings, a ``ParallelGPTBlock`` stack, a final
LayerNorm and an untied vocab head. The full forward attends through the
flash kernel; the cached forward through ``cached_attention``, and passes
per-row adapter ids to the blocks (``serving.adapters.AdapterSet``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.device import resolve_device
from ..core.random import generator as make_generator
from ..distributed.meta_parallel import ParallelGPTBlock
from ..nn.layer import Layer
from ..nn.layers.common import Embedding, Linear
from ..nn.layers.container import LayerList
from ..nn.layers.norm import LayerNorm

__all__ = ["TransformerLM"]


class TransformerLM(Layer):
    """Decoder-only LM. Weights are drawn from a generator seeded with
    ``seed`` on ``device`` (CUDA unless the caller passes ``"cpu"``; no
    fallback). ``dropout`` and ``use_flash_attention`` go to every block
    (``ParallelGPTBlock``): dropout on the attention probabilities and the
    MLP in training, and the flash route's policy (None: the router's
    default; False: the dense route)."""

    def __init__(self, vocab_size, d_model=256, num_heads=8, num_layers=4,
                 max_position=2048, dim_feedforward=None, dropout=0.0,
                 use_flash_attention=None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = make_generator(seed, dev)
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.max_position = int(max_position)
        self.embed = Embedding(vocab_size, d_model, **kw)
        self.pos_embed = Embedding(max_position, d_model, **kw)
        self.blocks = LayerList([
            ParallelGPTBlock(d_model, num_heads, dim_feedforward,
                             dropout=dropout,
                             use_flash_attention=use_flash_attention, **kw)
            for _ in range(num_layers)
        ])
        self.ln_f = LayerNorm(d_model, device=dev, dtype=dtype)
        self.head = Linear(d_model, vocab_size, **kw)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, ids, cache=None, pos=None, adapter=None):
        T = int(ids.shape[1])
        ar = torch.arange(T, device=ids.device)
        if cache is None:
            h = self.embed(ids) + self.pos_embed(ar)
            for blk in self.blocks:
                h = blk(h)
            return self.head(self.ln_f(h))
        if pos is None:
            raise ValueError("cache decoding needs `pos` ([B] int32)")
        # per-slot absolute positions: slot b's first query sits at pos[b]
        h = self.embed(ids) + self.pos_embed(pos.reshape(-1, 1) + ar)
        new_caches = []
        for blk, c in zip(self.blocks, cache):
            h, nc = blk(h, cache=c, pos=pos, adapter=adapter)
            new_caches.append(nc)
        return self.head(self.ln_f(h)), new_caches

    def load_quantized(self, path, deadline_ms=None):
        """Load an int8/fp8 ``jit.save_quantized`` checkpoint (either
        package's) into this model: the linear weights stay narrow and go
        through the quantized matmul. Returns the checkpoint's record with
        ``load_ms``."""
        from ..jit.save_load import load_quantized

        return load_quantized(self, path, deadline_ms=deadline_ms)

    def gen_cache(self, batch_size, max_length, dtype=None,
                  block_size=None, pool_blocks=None):
        if int(max_length) > self.max_position:
            raise ValueError(
                f"cache capacity {max_length} exceeds max_position="
                f"{self.max_position} (the position table)")
        return [blk.gen_cache(batch_size, max_length, dtype,
                              block_size=block_size, pool_blocks=pool_blocks)
                for blk in self.blocks]
