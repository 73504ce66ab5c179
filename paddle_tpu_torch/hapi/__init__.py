"""``hapi`` of the port, the high-level API (counterpart of
``paddle_tpu/hapi``; reference: python/paddle/hapi/: model.py,
callbacks.py, model_summary.py)."""
from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["callbacks", "Model", "flops", "summary"]
