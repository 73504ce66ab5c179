"""Optimizer wrappers (counterpart of ``paddle_tpu/optimizer/extras.py``):
``ExponentialMovingAverage``, ``LookaheadOptimizer`` and ``ModelAverage``.

Each keeps its extra state as float32 tensors (the slow weights of
Lookahead in the parameter's type) per parameter, on the parameter's
device, and writes the parameters in place under ``torch.no_grad``, where
the JAX package rebinds their arrays. ``apply()`` returns a context
manager that restores the trained weights on exit (``need_restore``);
``restore()`` does it by hand.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

__all__ = ["ExponentialMovingAverage", "LookaheadOptimizer", "ModelAverage"]


class _Swap:
    """Weights swapped in by ``apply`` and back by ``restore``."""

    def _swap_in(self, values, need_restore):
        with torch.no_grad():
            for p in self._params:
                self._backup[id(p)] = p.detach().clone()
                p.copy_(values(p).to(p.dtype))
        return self._restoring() if need_restore \
            else contextlib.nullcontext()

    @contextlib.contextmanager
    def _restoring(self):
        try:
            yield
        finally:
            self.restore()

    @torch.no_grad()
    def restore(self):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))


class ExponentialMovingAverage(_Swap):
    """``EMA_t = d EMA_{t-1} + (1 - d) theta_t`` in float32, applied with
    the bias correction ``1 / (1 - prod d_i)``; with ``thres_steps`` the
    decay at step t is ``min(decay, (1 + t) / (10 + t))``."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None,
                 name=None):
        self._decay = float(decay)
        self._thres = thres_steps is not None
        self._params: List[torch.Tensor] = list(parameters or [])
        self._ema: Dict[int, torch.Tensor] = {}
        self._backup: Dict[int, torch.Tensor] = {}
        self._t = 0
        # the product of the decays used: the bias correction's divisor
        # is 1 - prod(d_i), 1 - decay^t only without thres_steps
        self._decay_prod = 1.0

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None or not self._params:
            if parameters is not None:
                self._params = list(parameters)
            if not self._params:
                raise ValueError("EMA has no parameters bound")
        self._t += 1
        d = self._decay
        if self._thres:
            d = min(d, (1.0 + self._t) / (10.0 + self._t))
        self._decay_prod *= d
        for p in self._params:
            prev = self._ema.get(id(p))
            cur = p.detach().float()
            self._ema[id(p)] = cur * (1.0 - d) if prev is None \
                else prev * d + cur * (1.0 - d)

    def apply(self, need_restore=True):
        """Swap the bias-corrected averages in."""
        if self._t == 0:
            raise RuntimeError("EMA.apply() before any update()")
        corr = 1.0 - self._decay_prod
        return self._swap_in(lambda p: self._ema[id(p)] / corr,
                             need_restore)


class LookaheadOptimizer:
    """``k`` steps of ``inner_optimizer`` (the fast weights), then ``slow
    += alpha (fast - slow)`` and the fast weights reset to slow; the slow
    weights start at the weights before the first step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow: Dict[int, torch.Tensor] = {}
        self._calls = 0

    def _params(self):
        return [p for p in self.inner_optimizer._get_params()
                if p.requires_grad]

    def step(self):
        for p in self._params():
            if id(p) not in self._slow:
                self._slow[id(p)] = p.detach().clone()
        self.inner_optimizer.step()
        self._calls += 1
        if self._calls % self.k == 0:
            with torch.no_grad():
                for p in self._params():
                    slow = self._slow[id(p)]
                    slow = self._slow[id(p)] = slow + self.alpha * (p - slow)
                    p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None


class ModelAverage(_Swap):
    """The average of the parameters over a sliding window: ``accumulate()``
    (or ``step()``) after each optimizer step adds them in float32; when
    the window (``average_window_rate`` times the updates, capped at
    ``max_average_window``, at least ``min_average_window``) closes, the
    sums become the old sums and restart. ``apply()`` swaps in the mean
    over the current and old sums."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._params: List[torch.Tensor] = list(parameters or [])
        self._sum: Dict[int, torch.Tensor] = {}
        self._backup: Dict[int, torch.Tensor] = {}
        self._num_accumulates = 0
        self._num_updates = 0
        self._old_sum: Dict[int, torch.Tensor] = {}
        self._old_accumulates = 0

    @torch.no_grad()
    def accumulate(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        self._num_updates += 1
        self._num_accumulates += 1
        for p in self._params:
            cur = p.detach().float()
            prev = self._sum.get(id(p))
            # a float32 parameter's detach().float() is its own storage
            self._sum[id(p)] = cur.clone() if prev is None else prev + cur
        window = min(self._max_w, int(self._num_updates * self._rate))
        if (self._num_accumulates >= self._min_w
                and self._num_accumulates >= window):
            self._old_sum, self._sum = self._sum, {}
            self._old_accumulates = self._num_accumulates
            self._num_accumulates = 0

    step = accumulate

    def apply(self, need_restore=True):
        total = self._num_accumulates + self._old_accumulates
        if total == 0:
            raise RuntimeError("ModelAverage.apply() before accumulate()")

        def mean(p):
            s = sum(d[id(p)] for d in (self._sum, self._old_sum)
                    if id(p) in d)
            return s / total

        return self._swap_in(mean, need_restore)
