"""Seeding with explicit ``torch.Generator`` objects.

Where ``paddle_tpu`` threads ``jax.random`` keys, the port threads a
generator that the caller creates and passes; nothing here touches
PyTorch's global RNG. The two give different numbers from one seed, so
parity tests move weights and inputs across instead of re-seeding.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["generator", "xavier_normal"]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def xavier_normal(shape: Sequence[int], fan_in: int, fan_out: int, *,
                  generator: torch.Generator, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, sqrt(2 / (fan_in + fan_out))) draws: paddle's XavierNormal,
    the default initializer of the layers this slice ports."""
    std = math.sqrt(2.0 / float(fan_in + fan_out))
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32) * std
    return w.to(dtype)
