"""``vision`` of the port: the model zoo, the datasets, the numpy
transforms and the detection ops (``ops``: the deformable convolution and
the 13 detection ops of the JAX package's ``vision/ops.py``)."""
from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
