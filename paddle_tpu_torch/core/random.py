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

In a world of several ranks some draws must differ across ranks (dropout
on the rank's part of the batch) and some must agree (dropout on
activations that mp peers both hold). ``distributed.comm`` names those
streams here (:func:`set_streams`); a draw that asks for a named stream
takes it from the registry below, so ``recompute``'s replay
(:func:`get_states` / :func:`set_states`) and the capture's ``draw`` op
serve it as they serve the package's own generator. Outside a world a
named stream is the package's generator.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import torch

__all__ = ["generator", "seed", "get_seed", "default_generator",
           "derived_generator", "set_streams", "stream_generator",
           "get_states", "set_states", "seeded", "rand", "randn"]

_lock = threading.Lock()
_seed_value = 0
_generators: Dict[torch.device, torch.Generator] = {}
#: streams derived from the seed (a rank's dropout or shard-init stream),
#: made anew after each ``seed``
_derived: Dict[tuple, torch.Generator] = {}
#: the named streams of this rank's world -> their keys (``set_streams``)
_streams: Dict[str, tuple] = {}


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
        _derived.clear()
    return _seed_value


def _derived_seed(key: tuple) -> int:
    s = _seed_value
    for k in key:
        s = (s * 1_000_003 + int(k) + 1) % (2 ** 63)
    return s


def derived_generator(key: tuple, device: torch.device) -> torch.Generator:
    """A stream of its own for ``key`` (a tuple of ints naming its use, a
    rank's dropout for one) on ``device``, seeded from the last ``seed``
    and ``key``; the same key gives the same stream after the same seed."""
    dev = torch.device(device)
    key = tuple(int(k) for k in key)
    with _lock:
        g = _derived.get((key, dev))
        if g is None:
            g = _derived[(key, dev)] = generator(_derived_seed(key), dev)
    return g


def set_streams(keys: Dict[str, tuple]) -> None:
    """Name this rank's streams: ``{name: key}`` (``distributed.comm``
    sets them for its world, and clears them with ``{}``)."""
    with _lock:
        _streams.clear()
        _streams.update({n: tuple(int(k) for k in v)
                         for n, v in keys.items()})


def _stream_key(name: Optional[str]) -> tuple:
    return _streams.get(name, ()) if name else ()


def stream_generator(name: Optional[str],
                     device: Optional[torch.device] = None
                     ) -> torch.Generator:
    """The generator of the named stream on ``device``: its derived
    generator in a world that names it, else the package's generator."""
    key = _stream_key(name)
    return derived_generator(key, device) if key \
        else default_generator(device)


def get_states() -> Dict[tuple, torch.Tensor]:
    """The state of every generator of the registry (the package's and
    the derived streams'), for :func:`set_states`."""
    with _lock:
        out = {("d", d): g.get_state() for d, g in _generators.items()}
        out.update({("s",) + k: g.get_state() for k, g in _derived.items()})
    return out


def set_states(states: Dict[tuple, torch.Tensor]) -> None:
    """Put the registry back to ``states`` (:func:`get_states`): its
    generators take their saved state, and one made since is set back to
    the state it was made with."""
    for k, st in states.items():
        (default_generator(k[1]) if k[0] == "d"
         else derived_generator(k[1], k[2])).set_state(st)
    with _lock:
        for d, g in _generators.items():
            if ("d", d) not in states:
                g.manual_seed(_seed_value)
        for k, g in _derived.items():
            if ("s",) + k not in states:
                g.manual_seed(_derived_seed(k[0]))


@contextlib.contextmanager
def seeded(key: int):
    """Draws inside, from the package's generators and the named streams
    alike, come from generators seeded from ``key``; the registry is put
    back after."""
    global _seed_value
    from .device import resolve_device

    with _lock:
        saved = (_seed_value, dict(_generators), dict(_derived))
        _seed_value = int(key)
        for d in list(saved[1]) or [resolve_device(None)]:
            _generators[d] = generator(_seed_value, d)
        _derived.clear()
    try:
        yield
    finally:
        with _lock:
            _seed_value = saved[0]
            _generators.clear()
            _generators.update(saved[1])
            _derived.clear()
            _derived.update(saved[2])


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
          device: torch.device, seed: int = 0,
          key: Optional[List[int]] = None) -> torch.Tensor:
    """``kind`` "uniform" (``torch.rand``) or "normal" (``torch.randn``)
    of ``shape`` from the package's generator of ``device``, from the
    derived stream of ``key`` when one is given, or from a fresh generator
    seeded with ``seed`` when it is not 0."""
    if seed:
        gen = generator(seed, device)
    elif key:
        gen = derived_generator(tuple(key), device)
    else:
        gen = default_generator(device)
    return _drawn(kind, shape, gen, dtype, device)


@_draw.register_fake
def _(kind, shape, dtype, device, seed=0, key=None):
    return torch.empty(shape, dtype=dtype, device=device)


def _sample(kind, shape, gen, device, dtype, seed, stream):
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
        key = [] if gen is not None else list(_stream_key(stream))
        return _draw(kind, shape, dtype, dev, int(seed), key or None)
    if gen is None:
        gen = generator(seed, dev) if seed else stream_generator(stream, dev)
    return _drawn(kind, shape, gen, dtype, dev)


def rand(shape, *, generator: Optional[torch.Generator] = None,
         device=None, dtype=None, seed: int = 0,
         stream: Optional[str] = None) -> torch.Tensor:
    """Uniform [0, 1) of ``shape`` on ``device`` from ``generator`` (when
    None: the named ``stream`` of this rank's world, else the package's
    generator of the device; a fresh one seeded with ``seed`` when
    ``seed`` is not 0)."""
    return _sample("uniform", shape, generator, device, dtype, seed, stream)


def randn(shape, *, generator: Optional[torch.Generator] = None,
          device=None, dtype=None, seed: int = 0,
          stream: Optional[str] = None) -> torch.Tensor:
    """Standard normal of ``shape``, drawn as :func:`rand` draws."""
    return _sample("normal", shape, generator, device, dtype, seed, stream)
