"""Random state (counterpart of ``paddle_tpu/core/random.py``).

Where the JAX package keeps one global key and splits it per draw, the
port keeps one package-owned ``torch.Generator`` per device.
``paddle.seed(s)`` reseeds them all (and seeds those made later); layers,
initializers, dropout and the random creation ops draw from the
generator of their device when the caller passes none. Nothing here
touches PyTorch's global RNG. The two packages give different numbers
from one seed, so parity tests move weights and inputs across instead of
re-seeding.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

__all__ = ["generator", "seed", "get_seed", "default_generator"]

_lock = threading.Lock()
_seed_value = 0
_generators: Dict[torch.device, torch.Generator] = {}


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def seed(s: int) -> int:
    """paddle.seed(s): reseed the package's generator on every device."""
    global _seed_value
    with _lock:
        _seed_value = int(s)
        for g in _generators.values():
            g.manual_seed(_seed_value)
    return _seed_value


def get_seed() -> int:
    return _seed_value


def default_generator(device: Optional[torch.device] = None
                      ) -> torch.Generator:
    """The package's generator on ``device`` (the ``set_device`` default
    when None), made on first use from the last ``seed``."""
    from .device import resolve_device

    dev = resolve_device(device)
    with _lock:
        g = _generators.get(dev)
        if g is None:
            g = _generators[dev] = generator(_seed_value, dev)
    return g
