"""paddle.fluid.regularizer — 1.x regularizer spellings (counterpart of
the JAX package's ``paddle/fluid/regularizer.py``).

Reference: python/paddle/fluid/regularizer.py (L1DecayRegularizer /
L2DecayRegularizer, with L1Decay/L2Decay as the short aliases — the 2.x
names kept only the short form).
"""
from paddle_tpu_torch.regularizer import (  # noqa: F401
    L1Decay,
    L2Decay,
    WeightDecayRegularizer,
)

__all__ = [
    "L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
    "WeightDecayRegularizer",
]

L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
