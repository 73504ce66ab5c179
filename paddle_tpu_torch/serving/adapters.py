"""Adapter fleets: per-row LoRA-style deltas resident beside the base model
(counterpart of ``paddle_tpu/serving/adapters.py``).

An :class:`AdapterSet` registers a stacked pair of low-rank buffers on
every ``ParallelGPTBlock``, ``adapter_A`` ``[n_adapters, r, d_model]`` and
``adapter_B`` ``[n_adapters, ffn, r]``, and the block's MLP input becomes

    ``fc1(x) + scale * B[a] @ (A[a] @ x)``

with ``a`` the row's int adapter id, gathered from the stacks. Row 0 stays
zeros, so adapter 0 is the base model exactly; the ids ride
``jit.DecodeState.adapter`` as a ``[B]`` tensor, so one decode step serves
a batch that mixes fine-tunes. Loading a fine-tune writes its rows into
the resident buffers in place: nothing is rebuilt. The engine rejects a
``Request.adapter`` that is not loaded.

Env knobs, with the JAX package's meanings: ``PADDLE_SERVE_ADAPTERS``
(fleet size when the constructor is given none; 0 = no fleet unless one
is constructed, with 8 rows),
``PADDLE_SERVE_ADAPTER_RANK`` (low rank r, default 8),
``PADDLE_SERVE_ADAPTER_SCALE`` (the delta's scale, default 1.0).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["AdapterSet", "adapters_default", "adapter_rank_default",
           "adapter_scale_default"]

_COUNT_ENV = "PADDLE_SERVE_ADAPTERS"
_RANK_ENV = "PADDLE_SERVE_ADAPTER_RANK"
_SCALE_ENV = "PADDLE_SERVE_ADAPTER_SCALE"


def adapters_default() -> int:
    """``PADDLE_SERVE_ADAPTERS``: resident fleet size (0 = off)."""
    try:
        return max(int(os.environ.get(_COUNT_ENV, "0")), 0)
    except ValueError:
        return 0


def adapter_rank_default() -> int:
    """``PADDLE_SERVE_ADAPTER_RANK``: low rank r (default 8)."""
    try:
        return max(int(os.environ.get(_RANK_ENV, "8")), 1)
    except ValueError:
        return 8


def adapter_scale_default() -> float:
    """``PADDLE_SERVE_ADAPTER_SCALE``: the delta's scale (default 1.0)."""
    try:
        return float(os.environ.get(_SCALE_ENV, "1.0"))
    except ValueError:
        return 1.0


class AdapterSet:
    """A stacked low-rank adapter fleet over a ``TransformerLM``-shaped
    model (``.blocks`` of ``ParallelGPTBlock``). Attach it before serving::

        adapters = AdapterSet(model, n_adapters=8, rank=4)
        adapters.load(1)                          # drawn from its seed
        adapters.load(2, a_mats=..., b_mats=...)  # explicit weights
        eng = InferenceEngine(model, ...)
        eng.submit(Request(ids, adapter=1))
    """

    def __init__(self, model, n_adapters: Optional[int] = None,
                 rank: Optional[int] = None, scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        n = (int(n_adapters) if n_adapters is not None
             else (adapters_default() or 8))
        if n < 2:
            raise ValueError(
                f"AdapterSet needs n_adapters >= 2 (row 0 is the reserved "
                f"base/identity row; got {n})")
        self.n_adapters = n
        self.rank = int(rank) if rank is not None else adapter_rank_default()
        self.scale = (float(scale) if scale is not None
                      else adapter_scale_default())
        self.dtype = dtype
        self._loaded = {0}
        #: host copies of each loaded fine-tune's matrices, per block:
        #: aid -> [(A [r, d], B [ffn, r]), ...]
        self.weights: Dict[int, List] = {}
        self.blocks = list(model.blocks)
        for blk in self.blocks:
            dev = blk.fc1.weight.device
            blk.register_buffer("adapter_A", torch.zeros(
                n, self.rank, blk.d_model, dtype=dtype, device=dev))
            blk.register_buffer("adapter_B", torch.zeros(
                n, blk.fc1.out_features, self.rank, dtype=dtype,
                device=dev))
            blk._adapter_scale = self.scale
        model._serve_adapters = self

    @property
    def resident(self) -> List[int]:
        return sorted(self._loaded)

    def is_loaded(self, aid: int) -> bool:
        return int(aid) in self._loaded

    def _check_id(self, aid: int) -> int:
        aid = int(aid)
        if not 1 <= aid < self.n_adapters:
            raise ValueError(
                f"adapter id {aid} out of range 1..{self.n_adapters - 1} "
                f"(0 is the reserved base row)")
        return aid

    @torch.no_grad()
    def load(self, aid: int, *, seed: Optional[int] = None, a_mats=None,
             b_mats=None) -> None:
        """Write one fine-tune's rows into the resident stacks, in place:
        explicit per-block ``a_mats``/``b_mats``, or a small random delta
        drawn from ``np.random.RandomState(seed)`` (``17 + aid`` by
        default), the JAX package's draws, so both hold the same rows."""
        aid = self._check_id(aid)
        if a_mats is None:
            rng = np.random.RandomState((17 + aid) if seed is None
                                        else int(seed))
            a_mats, b_mats = [], []
            for blk in self.blocks:
                d, ffn = blk.d_model, blk.fc1.out_features
                a_mats.append(rng.normal(0.0, 1.0 / np.sqrt(d),
                                         (self.rank, d)).astype(np.float32))
                b_mats.append(rng.normal(
                    0.0, 1.0 / np.sqrt(self.rank),
                    (ffn, self.rank)).astype(np.float32))
        if len(a_mats) != len(self.blocks) \
                or len(b_mats) != len(self.blocks):
            raise ValueError(
                f"adapter {aid}: want one (A, B) pair per block "
                f"({len(self.blocks)}), got {len(a_mats)}/{len(b_mats)}")
        for blk, a_rows, b_rows in zip(self.blocks, a_mats, b_mats):
            for buf, rows in ((blk.adapter_A, a_rows),
                              (blk.adapter_B, b_rows)):
                buf[aid] = torch.as_tensor(np.asarray(rows)).to(buf)
        self._loaded.add(aid)
        self.weights[aid] = [(np.asarray(a), np.asarray(b))
                             for a, b in zip(a_mats, b_mats)]

    @torch.no_grad()
    def unload(self, aid: int) -> None:
        """Zero the rows and drop residency (the engine then rejects the
        id)."""
        aid = self._check_id(aid)
        for blk in self.blocks:
            blk.adapter_A[aid] = 0
            blk.adapter_B[aid] = 0
        self._loaded.discard(aid)
        self.weights.pop(aid, None)
