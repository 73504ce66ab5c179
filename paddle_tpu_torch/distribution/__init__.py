"""paddle.distribution: probability distributions (counterpart of
``paddle_tpu/distribution/__init__.py``).

Reference: python/paddle/distribution.py (Distribution :41, Uniform :168,
Normal :390, Categorical :640). The JAX package's math, on torch: the
parameters are float32 tensors (broadcast as ``torch.broadcast_shapes``
does), ``log_prob`` and ``probs`` are ops of the eager tape (they carry a
gradient to ``value``), and the draws come from the package's generator of
the parameters' device (``core/random.py``), or from a fresh generator
seeded with ``seed`` when it is not 0. The two packages draw different
numbers from one seed; shapes, supports and moments agree.

``Categorical`` keeps the reference's two normalizations, a departure
from a plain categorical that the JAX package keeps too (``ADVICE.md``):
``logits`` are non-negative RELATIVE WEIGHTS, so ``probs``, ``log_prob``
and ``sample`` normalize by their sum, while ``entropy`` and
``kl_divergence`` (distribution.py:812-860) exp-normalize them (a softmax
after max-subtraction).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import autograd as AG
from ..core import random as rnd
from ..core.device import resolve_device
from ..core.tensor import Tensor

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _as_raw(v, dtype=torch.float32):
    if isinstance(v, Tensor):
        return v._data.detach().to(dtype)
    if isinstance(v, torch.Tensor):
        return v.detach().to(dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype,
                           device=resolve_device(None))


def _value(v):
    return v if isinstance(v, Tensor) else Tensor(v)


class Distribution:
    """Abstract base (distribution.py:41)."""

    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (distribution.py:168): a sample's shape is
    ``sample_shape + broadcast(low, high).shape``."""

    def __init__(self, low, high, name=None):
        self.low = _as_raw(low)
        self.high = _as_raw(high).to(self.low.device)
        self.name = name or "Uniform"

    def _bshape(self, shape):
        return tuple(shape) + tuple(torch.broadcast_shapes(
            self.low.shape, self.high.shape))

    def sample(self, shape, seed=0):
        u = rnd.rand(self._bshape(shape), device=self.low.device,
                     seed=int(seed))
        return Tensor._wrap(self.low + u * (self.high - self.low))

    def log_prob(self, value):
        def f(v):
            inside = (v > self.low) & (v < self.high)
            lp = -torch.log(self.high - self.low)
            return torch.where(inside, lp, torch.full_like(lp, -math.inf))

        return AG.apply(f, (_value(value)._data,), name="uniform_log_prob")

    def probs(self, value):
        def f(v):
            inside = (v > self.low) & (v < self.high)
            p = 1.0 / (self.high - self.low)
            return torch.where(inside, p, torch.zeros_like(p))

        return AG.apply(f, (_value(value)._data,), name="uniform_probs")

    def entropy(self):
        return Tensor._wrap(torch.log(self.high - self.low))


class Normal(Distribution):
    """N(loc, scale^2) (distribution.py:390)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _as_raw(loc)
        self.scale = _as_raw(scale).to(self.loc.device)
        self.name = name or "Normal"

    def _bshape(self, shape):
        return tuple(shape) + tuple(torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))

    def sample(self, shape, seed=0):
        z = rnd.randn(self._bshape(shape), device=self.loc.device,
                      seed=int(seed))
        return Tensor._wrap(self.loc + z * self.scale)

    def entropy(self):
        # 0.5 + 0.5 log(2 pi) + log(scale), broadcast to loc's shape
        scale = torch.broadcast_to(self.scale, torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))
        return Tensor._wrap(0.5 + 0.5 * math.log(2 * math.pi)
                            + torch.log(scale))

    def log_prob(self, value):
        def f(v):
            var = self.scale * self.scale
            return (-((v - self.loc) ** 2) / (2 * var)
                    - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

        return AG.apply(f, (_value(value)._data,), name="normal_log_prob")

    def probs(self, value):
        def f(v):
            var = self.scale * self.scale
            return torch.exp(-((v - self.loc) ** 2) / (2 * var)) \
                / torch.sqrt(2 * math.pi * var)

        return AG.apply(f, (_value(value)._data,), name="normal_probs")

    def kl_divergence(self, other: "Normal"):
        """KL(self || other) (distribution.py:595)."""
        ratio = self.scale / other.scale
        t1 = (self.loc - other.loc) / other.scale
        return Tensor._wrap(0.5 * (ratio * ratio + t1 * t1) - 0.5
                            - torch.log(ratio))


class Categorical(Distribution):
    """Categorical (distribution.py:640) over non-negative relative
    weights ``logits`` (the module docstring's two normalizations)."""

    def __init__(self, logits, name=None):
        self.logits = _as_raw(logits)
        self.name = name or "Categorical"

    def _log_probs(self):
        w = self.logits
        return torch.log(w.clamp_min(1e-30)) - torch.log(
            w.sum(-1, keepdim=True).clamp_min(1e-30))

    def _softmax_log_probs(self):
        """exp-normalized log-probs (the entropy/kl path)."""
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape):
        """Indices of ``shape + logits.shape[:-1]`` drawn from the
        sum-normalized weights."""
        shape = tuple(int(d) for d in shape)
        n = int(np.prod(shape)) if shape else 1
        p = torch.exp(self._log_probs())
        batch = tuple(p.shape[:-1])
        flat = p.reshape(-1, p.shape[-1])
        # one uniform per draw, inverted through each row's CDF
        u = rnd.rand((n, flat.shape[0]), device=p.device,
                     dtype=torch.float32)
        cdf = torch.cumsum(flat, dim=-1)
        cdf = cdf / cdf[:, -1:]
        idx = torch.searchsorted(cdf.expand(n, *cdf.shape).contiguous(),
                                 u[..., None]).squeeze(-1)
        idx = idx.clamp_max(flat.shape[-1] - 1)
        return Tensor._wrap(idx.reshape(shape + batch).to(torch.int64))

    def entropy(self):
        lp = self._softmax_log_probs()
        return Tensor._wrap(-(torch.exp(lp) * lp).sum(-1))

    def kl_divergence(self, other: "Categorical"):
        lp = self._softmax_log_probs()
        lq = other._softmax_log_probs()
        return Tensor._wrap((torch.exp(lp) * (lp - lq)).sum(-1))

    def _select(self, table, v):
        v = v.to(torch.int64)
        if self.logits.dim() == 1:
            return table[v]
        return torch.gather(table, -1, v[..., None])[..., 0]

    def probs(self, value):
        v = _value(np.asarray(value) if not isinstance(
            value, (Tensor, torch.Tensor)) else value)
        with torch.no_grad():
            return Tensor._wrap(self._select(
                torch.exp(self._log_probs()), v._data.to(
                    self.logits.device)))

    def log_prob(self, value):
        v = _value(np.asarray(value) if not isinstance(
            value, (Tensor, torch.Tensor)) else value)
        with torch.no_grad():
            return Tensor._wrap(self._select(
                self._log_probs(), v._data.to(self.logits.device)))
