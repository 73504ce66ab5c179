"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip maps a list of ``(parameter, gradient)`` pairs to a new list;
a ``None`` gradient, and a parameter whose ``need_clip`` attribute is
False, pass through unchanged. Norms are taken in float32 and the scale
is applied in the gradient's type, on the device (no host read).
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose own L2 norm exceeds ``clip_norm`` down
    to it. A shard's norm is its full gradient's: the squares of
    tensor-parallel shards are summed over the mp group, and of ZeRO
    gradient shards over the dp group (one all-reduce a group for all of
    them, ``distributed.meta_parallel.norm_groups``)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = {i: g.float().square().sum()
              for i, (p, g) in enumerate(params_grads) if _clipped(p, g)}
        from ..distributed import collective
        from ..distributed.meta_parallel import norm_groups

        by_groups = {}
        for i in sq:
            gs = norm_groups(*params_grads[i])
            if gs:
                by_groups.setdefault(tuple(id(x) for x in gs),
                                     (gs, []))[1].append(i)
        for gs, idx in by_groups.values():
            summed = torch.stack([sq[i] for i in idx])
            for g in gs:
                summed = collective.all_reduce_(summed, group=g)
            sq.update(zip(idx, summed.unbind()))
        out = []
        for i, (p, g) in enumerate(params_grads):
            if i not in sq:
                out.append((p, g))
                continue
            n = torch.sqrt(sq[i])
            scale = torch.where(n > self.clip_norm, self.clip_norm / n,
                                torch.ones_like(n))
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by ``clip_norm / (global_norm + 1e-6)`` when the
    L2 norm over all of them exceeds ``clip_norm``. Under tensor
    parallelism and ZeRO the norm is that of the full gradients: the
    shards' squares are summed over their groups
    (``distributed.meta_parallel.global_square_sum``)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        pairs = [(p, g) for p, g in params_grads if _clipped(p, g)]
        if not pairs:
            return params_grads
        from ..distributed.meta_parallel import global_square_sum

        gnorm = torch.sqrt(global_square_sum(pairs))
        scale = torch.where(gnorm > self.clip_norm,
                            self.clip_norm / (gnorm + 1e-6),
                            torch.ones_like(gnorm))
        return [(p, g * scale.to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]
