"""Optimizers of the port (counterpart of ``paddle_tpu.optimizer``), their
learning-rate schedulers (``optimizer.lr``) and the wrappers of
``optimizer.extras`` (EMA, Lookahead, ModelAverage)."""
from . import extras, lr
from .extras import ExponentialMovingAverage, LookaheadOptimizer, ModelAverage
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Lars, LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "extras", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars",
           "LarsMomentum", "ExponentialMovingAverage", "LookaheadOptimizer",
           "ModelAverage"]
