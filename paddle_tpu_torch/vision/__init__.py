"""``vision`` of the port: the model zoo, the datasets and the numpy
transforms (``ops`` is ROADMAP queue A item 5)."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
