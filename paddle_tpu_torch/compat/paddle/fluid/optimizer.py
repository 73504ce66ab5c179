"""paddle.fluid.optimizer — 1.x optimizer spellings (counterpart of the
JAX package's ``paddle/fluid/optimizer.py``).

Reference: python/paddle/fluid/optimizer.py. The fluid classes are the
port's `optimizer` ones with three renames folded in:
`parameter_list=` -> `parameters=`, `regularization=` -> `weight_decay=`,
and the `...Optimizer` class-name suffix. `opt.minimize(avg_cost)` in
static mode records the backward+update into the default program exactly
as the modern classes do.
"""
from __future__ import annotations

from paddle_tpu_torch import optimizer as _opt
from paddle_tpu_torch.optimizer import (  # noqa: F401
    ExponentialMovingAverage,
    LookaheadOptimizer,
    ModelAverage,
    Optimizer,
)

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer", "Adamax",
    "AdamaxOptimizer", "Adadelta", "AdadeltaOptimizer", "RMSProp",
    "RMSPropOptimizer", "Lamb", "LambOptimizer", "LarsMomentum",
    "LarsMomentumOptimizer", "ExponentialMovingAverage",
    "LookaheadOptimizer", "ModelAverage",
]


def _fluidize(cls):
    """Wrap a modern optimizer class with the fluid kwarg spellings."""

    class _Fluid(cls):
        def __init__(self, *args, **kwargs):
            if "parameter_list" in kwargs:
                kwargs["parameters"] = kwargs.pop("parameter_list")
            if "regularization" in kwargs:
                kwargs["weight_decay"] = kwargs.pop("regularization")
            kwargs.pop("use_global_beta_pow", None)  # fluid-only perf knob
            super().__init__(*args, **kwargs)

    _Fluid.__name__ = cls.__name__ + "Optimizer"
    _Fluid.__qualname__ = _Fluid.__name__
    return _Fluid


SGDOptimizer = _fluidize(_opt.SGD)
MomentumOptimizer = _fluidize(_opt.Momentum)
AdagradOptimizer = _fluidize(_opt.Adagrad)
AdamOptimizer = _fluidize(_opt.Adam)
AdamaxOptimizer = _fluidize(_opt.Adamax)
AdadeltaOptimizer = _fluidize(_opt.Adadelta)
RMSPropOptimizer = _fluidize(_opt.RMSProp)
LambOptimizer = _fluidize(_opt.Lamb)
LarsMomentumOptimizer = _fluidize(_opt.LarsMomentum)

# fluid also exposed the bare names
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
