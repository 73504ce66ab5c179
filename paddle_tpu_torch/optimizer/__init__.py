"""Optimizers of the port (counterpart of ``paddle_tpu.optimizer``) and
their learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "Optimizer", "Adam", "AdamW"]
