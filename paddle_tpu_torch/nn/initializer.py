"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``init(shape, dtype, *, device=None,
generator=None) -> torch.Tensor``: the draw runs in float32 on ``device``
(the ``set_device`` default when None) from ``generator`` (the package's
generator of that device, which ``paddle.seed`` seeds, when None) and is
cast to ``dtype`` (the default float type when None). The fan rules are
the JAX package's (``_fans``: a 2-D ``[in, out]`` weight has fan-in
``in``; a convolution's ``[out, in, *k]`` has fan-in ``in * prod(k)``).
The draws are not JAX's: the same seed gives other numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype, default_float_dtype
from ..core.random import default_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign"]


class Initializer:
    """Base: :meth:`_draw` makes the float32 values; ``__call__`` places
    and casts them."""

    def __call__(self, shape, dtype=None, *, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator if generator is not None else default_generator(dev)
        shape = tuple(int(s) for s in shape)
        out = self._draw(shape, dev, gen)
        return out.to(convert_dtype(dtype) or default_float_dtype())

    def _draw(self, shape, device, generator) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, device, generator):
        return torch.full(shape, float(self.value), device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, device, generator):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (self.high - self.low) + self.low


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator):
        return torch.randn(shape, generator=generator, device=device) \
            * self.std + self.mean


class TruncatedNormal(Initializer):
    """Normal(mean, std) cut to two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator):
        z = torch.empty(shape, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return z * self.std + self.mean


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, device, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._draw(shape, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, device, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)._draw(shape, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _draw(self, shape, device, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._draw(shape, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _draw(self, shape, device, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))._draw(shape, device,
                                                       generator)


class Assign(Initializer):
    """A given value (numpy array, list, ``Tensor``) of the parameter's
    shape."""

    def __init__(self, value):
        self.value = value

    def _draw(self, shape, device, generator):
        from ..core.tensor import to_torch

        v = to_torch(self.value)
        arr = torch.as_tensor(v.detach().cpu() if isinstance(
            v, torch.Tensor) else np.asarray(v), dtype=torch.float64)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {tuple(arr.shape)} "
                             f"!= param shape {shape}")
        return arr.to(device)


def _resolve_initializer(init):
    if callable(init):
        return init
    raise TypeError(f"Cannot interpret {init!r} as an initializer")
