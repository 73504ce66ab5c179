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
    to it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            n = torch.sqrt(g.float().square().sum())
            scale = torch.where(n > self.clip_norm, self.clip_norm / n,
                                torch.ones_like(n))
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale all gradients by ``clip_norm / (global_norm + 1e-6)`` when the
    L2 norm over all of them exceeds ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return params_grads
        gnorm = torch.sqrt(torch.stack(sq).sum())
        scale = torch.where(gnorm > self.clip_norm,
                            self.clip_norm / (gnorm + 1e-6),
                            torch.ones_like(gnorm))
        return [(p, g * scale.to(g.dtype) if _clipped(p, g) else g)
                for p, g in params_grads]
