"""``vision`` of the port: the model zoo, the datasets, the numpy
transforms and the detection ops (``ops``: the deformable convolution so
far; the rest is ROADMAP queue A item 5)."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
