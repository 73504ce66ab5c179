"""``fleet`` on one process (counterpart of
``paddle_tpu/distributed/fleet/base.py``): ``fleet.init`` records the
strategy, and ``fleet.distributed_optimizer`` wraps the optimizer so that
it carries the strategy (``user_defined_strategy``) to ``jit.TrainStep``,
which applies its ``amp`` option.

The port runs the single-process form: every degree of
``hybrid_configs`` must be 1, and a strategy option other than ``amp``
is kept as data (``TrainStep`` refuses it, naming it).
"""
from __future__ import annotations

from typing import Optional

from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet"]


class _DistributedOptimizer:
    """The user's optimizer with the strategy attached: every attribute
    but ``user_defined_strategy`` is read from and written to the inner
    optimizer (``_step_count``, ``_lr``, the accumulators)."""

    def __init__(self, optimizer, strategy: DistributedStrategy):
        object.__setattr__(self, "_inner", optimizer)
        object.__setattr__(self, "user_defined_strategy", strategy)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in ("_inner", "user_defined_strategy"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._strategy: Optional[DistributedStrategy] = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Collective mode on one process: record ``strategy`` (a default
        one when None). Raises for parameter-server mode and for any
        parallel degree above 1."""
        if not is_collective:
            raise NotImplementedError(
                "fleet.init: parameter-server mode is not ported; use "
                "is_collective=True")
        strategy = strategy or DistributedStrategy()
        degrees = {k: int(v) for k, v in strategy.hybrid_configs.items()}
        if strategy.tensor_parallel:
            degrees["tensor_parallel_degree"] = int(
                strategy.tensor_parallel_configs["tensor_parallel_degree"])
        wide = {k: v for k, v in degrees.items() if v != 1}
        if wide:
            raise NotImplementedError(
                f"fleet.init: {wide} — the port runs one process "
                "(dp = mp = pp = sp = 1) so far")
        self._strategy = strategy
        self._is_initialized = True
        return self

    def distributed_optimizer(self, optimizer, strategy=None):
        """``optimizer`` carrying the strategy of :meth:`init` (or
        ``strategy``, which then replaces it)."""
        if not self._is_initialized:
            raise RuntimeError("call fleet.init() first")
        if strategy is not None:
            self._strategy = strategy
        return _DistributedOptimizer(optimizer, self._strategy)


fleet = Fleet()
