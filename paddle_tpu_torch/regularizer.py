"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

Each adds a term to a parameter's gradient before the gradient clip:
``L2Decay(c)`` adds ``c * p``, ``L1Decay(c)`` adds ``c * sign(p)``. An
optimizer takes one as ``weight_decay=`` (a float means ``L2Decay`` of
it); a parameter's own ``regularizer`` attribute takes precedence.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def grad_term(self, p: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def grad_term(self, p):
        return self._coeff * p


class L1Decay(WeightDecayRegularizer):
    def grad_term(self, p):
        return self._coeff * torch.sign(p)
