"""Random state (counterpart of ``paddle_tpu/core/random.py``).

Where the JAX package keeps one global key and splits it per draw, the
port keeps one package-owned ``torch.Generator`` per device.
``paddle.seed(s)`` reseeds them all (and seeds those made later); layers,
initializers, dropout and the random creation ops draw from the
generator of their device when the caller passes none. Nothing here
touches PyTorch's global RNG. The two packages give different numbers
from one seed, so parity tests move weights and inputs across instead of
re-seeding.

:func:`rand` and :func:`randn` are the draws of dropout and the random
creation ops. Inside a ``to_static`` capture (``autograd.in_trace()``)
each becomes one call of the custom op ``paddle_tpu_torch::draw``, which
draws from the package's generator whenever the captured program runs:
a capture never bakes in one draw, and it never reads PyTorch's global
generator (the counterpart of the JAX package's per-call trace key).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

__all__ = ["generator", "seed", "get_seed", "default_generator", "rand",
           "randn"]

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


def _drawn(kind, shape, gen, dtype, device):
    draw = torch.rand if kind == "uniform" else torch.randn
    return draw(shape, generator=gen, dtype=dtype, device=device)


@torch.library.custom_op("paddle_tpu_torch::draw", mutates_args=())
def _draw(kind: str, shape: List[int], dtype: torch.dtype,
          device: torch.device, seed: int = 0) -> torch.Tensor:
    """``kind`` "uniform" (``torch.rand``) or "normal" (``torch.randn``)
    of ``shape`` from the package's generator of ``device``, or from a
    fresh generator seeded with ``seed`` when it is not 0."""
    return _drawn(kind, shape, generator(seed, device) if seed
                  else default_generator(device), dtype, device)


@_draw.register_fake
def _(kind, shape, dtype, device, seed=0):
    return torch.empty(shape, dtype=dtype, device=device)


def _sample(kind, shape, gen, device, dtype, seed):
    from .autograd import in_trace
    from .device import resolve_device

    dev = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    shape = [int(d) for d in shape]
    if in_trace():
        if gen is not None and not seed and gen is not default_generator(
                dev):
            raise NotImplementedError(
                "a draw from a caller's own generator inside a to_static "
                "capture: the captured program draws from the package's "
                "generator (or from a seed)")
        return _draw(kind, shape, dtype, dev, int(seed))
    if gen is None:
        gen = generator(seed, dev) if seed else default_generator(dev)
    return _drawn(kind, shape, gen, dtype, dev)


def rand(shape, *, generator: Optional[torch.Generator] = None,
         device=None, dtype=None, seed: int = 0) -> torch.Tensor:
    """Uniform [0, 1) of ``shape`` on ``device`` from ``generator`` (the
    package's generator of the device when None; a fresh one seeded with
    ``seed`` when ``seed`` is not 0)."""
    return _sample("uniform", shape, generator, device, dtype, seed)


def randn(shape, *, generator: Optional[torch.Generator] = None,
          device=None, dtype=None, seed: int = 0) -> torch.Tensor:
    """Standard normal of ``shape``, drawn as :func:`rand` draws."""
    return _sample("normal", shape, generator, device, dtype, seed)
