"""Optimizers of the port (counterpart of ``paddle_tpu.optimizer``) and
their learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
