"""``text`` of the port: NLP datasets (counterpart of
``paddle_tpu/text``; reference: python/paddle/text/__init__.py, which
re-exports datasets/)."""
from .datasets import *  # noqa: F401,F403
from . import datasets  # noqa: F401

__all__ = datasets.__all__
