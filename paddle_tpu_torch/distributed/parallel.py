"""Data-parallel training at a world size of one (counterpart of
``paddle_tpu/distributed/parallel.py`` and of ``ParallelEnv`` /
``init_parallel_env`` in ``paddle_tpu/distributed/comm.py``).

Reference: python/paddle/fluid/dygraph/parallel.py (``DataParallel``
:322, ``ParallelEnv``, ``init_parallel_env`` :57). The port runs one
trainer on one card so far: ``init_parallel_env`` sets up that world and
``DataParallel`` wraps a layer as the identity of one replica (its
parameters stay where they are; loss scaling is the identity, as the
global mean already divides by the global batch). A launch of several
trainers (``PADDLE_TRAINERS_NUM`` > 1) raises in each, as
``comm.get_world_size`` does: several ranks are a later slice.
"""
from __future__ import annotations

import contextlib
import os

from ..nn.layer import Layer
from . import comm

__all__ = ["DataParallel", "ParallelEnv", "init_parallel_env"]


class ParallelEnv:
    """The trainer environment (reference: fluid/dygraph/parallel.py
    ParallelEnv): rank and world size of the one-process world."""

    @property
    def rank(self) -> int:
        return comm.get_rank()

    @property
    def world_size(self) -> int:
        return comm.get_world_size()

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def local_rank(self) -> int:
        return self.rank

    @property
    def dev_id(self) -> int:
        return self.rank

    @property
    def device_id(self) -> int:
        return self.rank

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self) -> list:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return [e for e in eps.split(",") if e]


def init_parallel_env(backend=None) -> ParallelEnv:
    """Set up the trainer world (reference: parallel.py:57): the one-device
    mesh of ``comm``. Above one trainer it raises."""
    comm.get_world_size()
    if comm.hybrid_mesh() is None:
        comm.init_hybrid_mesh()
    return ParallelEnv()


class DataParallel(Layer):
    """Wrap a Layer for data-parallel training (parallel.py:322 parity):
    at a world size of one, the layer itself. ``scale_loss`` is the
    identity and ``no_sync`` a no-op context, as in the JAX package;
    ``comm_buffer_size_MB``, ``last_comm_buffer_size_MB`` and
    ``find_unused_parameters`` are taken and change nothing (no gradient
    is communicated)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size_MB=25,
                 last_comm_buffer_size_MB=1, find_unused_parameters=False,
                 group=None):
        comm.get_world_size()
        super().__init__()
        self._layers = layers

    def scale_loss(self, loss):
        return loss

    def no_sync(self):
        return contextlib.nullcontext()

    # state passthrough: checkpoints are of the wrapped model
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, use_structured_name=True):
        return self._layers.set_state_dict(state_dict, use_structured_name)

    set_dict = set_state_dict
    load_dict = set_state_dict


def _forward(self, *inputs, **kwargs):
    return self._layers(*inputs, **kwargs)


# bound after the class body, so the wrapped layer gets its inputs as the
# caller passed them (a forward defined in the class would convert them at
# the package's tensor boundary)
DataParallel.forward = _forward
