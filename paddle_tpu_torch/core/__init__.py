"""Core of the port: device selection, types, flags, seeding, the eager
``Tensor`` and its autograd."""
from . import autograd, device, dtype, flags, random, tensor
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .device import (CPUPlace, CUDAPlace, Place, get_device,
                     is_compiled_with_cuda, resolve_device, set_device)
from .dtype import get_default_dtype, set_default_dtype
from .random import generator, get_seed, seed
from .tensor import Parameter, Tensor, to_tensor

__all__ = ["autograd", "device", "dtype", "flags", "random", "tensor",
           "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled", "CPUPlace", "CUDAPlace", "Place",
           "get_device", "is_compiled_with_cuda", "resolve_device",
           "set_device", "get_default_dtype", "set_default_dtype",
           "generator", "get_seed", "seed", "Parameter", "Tensor",
           "to_tensor"]
