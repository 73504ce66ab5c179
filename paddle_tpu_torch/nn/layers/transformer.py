"""The KV-cache record of ``paddle_tpu/nn/layers/transformer.py``.

Only ``MultiHeadAttention.Cache`` is ported so far: the serving layers
pass per-layer caches in it. The layer itself comes with a later slice.
"""
from __future__ import annotations

import collections

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention:
    """Namespace of the cache record, as in paddle: ``Cache(k, v)`` holds
    one layer's ``[B, H, cap, Dh]`` key and value buffers."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
