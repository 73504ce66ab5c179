"""``vision`` of the port: the model zoo's LeNet and ResNets."""
from . import models

__all__ = ["models"]
