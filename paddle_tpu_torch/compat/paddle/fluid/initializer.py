"""paddle.fluid.initializer — 1.x initializer spellings (counterpart of
the JAX package's ``paddle/fluid/initializer.py``).

Reference: python/paddle/fluid/initializer.py. Fluid names carry flags the
2.x split classes encode in the class name (`Xavier(uniform=True)` vs
`XavierUniform`); each alias resolves the flag and returns the modern
initializer object, so `ParamAttr(initializer=fluid.initializer.Xavier())`
feeds the existing create_parameter path unchanged.
"""
from __future__ import annotations

from paddle_tpu_torch.nn import initializer as _init
from paddle_tpu_torch.nn.initializer import (  # noqa: F401
    Assign,
    Constant,
    Initializer,
    KaimingNormal,
    KaimingUniform,
    Normal,
    TruncatedNormal,
    Uniform,
    XavierNormal,
    XavierUniform,
)

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
    "Xavier", "MSRA", "Assign", "NumpyArrayInitializer", "Bilinear",
    "ConstantInitializer", "UniformInitializer", "NormalInitializer",
    "TruncatedNormalInitializer", "XavierInitializer", "MSRAInitializer",
    "KaimingNormal", "KaimingUniform", "XavierNormal", "XavierUniform",
]


def Xavier(uniform=True, fan_in=None, fan_out=None, seed=0):
    """initializer.py:487 XavierInitializer."""
    cls = _init.XavierUniform if uniform else _init.XavierNormal
    return cls(fan_in=fan_in, fan_out=fan_out)


def MSRA(uniform=True, fan_in=None, seed=0, negative_slope=0.0,
         nonlinearity="relu"):
    """initializer.py:613 MSRAInitializer (Kaiming He)."""
    cls = _init.KaimingUniform if uniform else _init.KaimingNormal
    try:
        return cls(fan_in=fan_in, negative_slope=negative_slope,
                   nonlinearity=nonlinearity)
    except TypeError:  # older signature without the slope kwargs
        return cls(fan_in=fan_in)


def NumpyArrayInitializer(value):
    """initializer.py:872 — Assign in fluid spelling."""
    return _init.Assign(value)


def Bilinear():
    """initializer.py:770 BilinearInitializer: upsampling-kernel init for
    conv-transpose. Out of the alias scope (no consumer in the tree);
    listed so scripts fail with a named error, not an AttributeError."""
    raise NotImplementedError(
        "fluid.initializer.Bilinear is out of scope: no deconv-upsampling "
        "consumer in this tree; use nn.initializer.Assign with a "
        "precomputed bilinear kernel"
    )


# the verbose 1.x class names are the same factories
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
