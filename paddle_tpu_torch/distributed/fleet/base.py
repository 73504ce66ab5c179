"""``fleet`` (counterpart of ``paddle_tpu/distributed/fleet/base.py``):
``fleet.init`` sets up the trainer world and lays it out as the hybrid
mesh of ``strategy.hybrid_configs`` (or ``tensor_parallel_configs``), at
any ``dp x mp``; ``fleet.distributed_model`` wraps the model for data
parallelism over the mesh's dp group (``DataParallel``: the gradient
reduction and ``shard_input``); ``fleet.distributed_optimizer`` wraps the
optimizer so that it carries the strategy (``user_defined_strategy``) to
``jit.TrainStep``, which applies its ``amp`` option and runs the step
across the world.

As in the JAX package, a ``dp_degree`` left at 1 takes what ``mp``, ``pp``
and ``sp`` leave of the world. With ``pp_degree`` above 1,
``distributed_model`` takes a ``PipelineLayer`` and returns its
``PipelineParallel`` (``pipeline_configs``' ``accumulate_steps`` and
``schedule_mode``); with ``sp_degree`` above 1 the ``DataParallel`` it
returns averages the gradients over dp x sp and its ``shard_input`` cuts
the batch over dp and the sequence (axis 1) over sp. A strategy option
the port has not ported is kept as data and refused by ``TrainStep``,
naming it.
"""
from __future__ import annotations

import os
from typing import Optional

from .. import collective, comm
from ..parallel import DataParallel
from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet", "HybridCommunicateGroup"]


class HybridCommunicateGroup:
    """Topology accessors (reference: fleet/base/topology.py
    HybridCommunicateGroup): the degrees of the mesh's axes, this rank's
    index on each, and its dp and mp groups."""

    def __init__(self, mesh: comm.HybridMesh):
        self.mesh = mesh

    def get_data_parallel_world_size(self):
        return int(self.mesh.shape["dp"])

    def get_model_parallel_world_size(self):
        return int(self.mesh.shape["mp"])

    def get_pipe_parallel_world_size(self):
        return int(self.mesh.shape["pp"])

    def get_sequence_parallel_world_size(self):
        return int(self.mesh.shape["sp"])

    def get_data_parallel_rank(self):
        return self.mesh.axis_rank("dp")

    def get_model_parallel_rank(self):
        return self.mesh.axis_rank("mp")

    def get_stage_id(self):
        return self.mesh.axis_rank("pp")

    def get_data_parallel_group(self):
        return self.mesh.group("dp")

    def get_model_parallel_group(self):
        return self.mesh.group("mp")

    def topology(self):
        return dict(self.mesh.shape)


class _DistributedOptimizer:
    """The user's optimizer with the strategy attached: every attribute
    but ``user_defined_strategy`` is read from and written to the inner
    optimizer (``_step_count``, ``_lr``, the accumulators)."""

    def __init__(self, optimizer, strategy: DistributedStrategy):
        object.__setattr__(self, "_inner", optimizer)
        object.__setattr__(self, "user_defined_strategy", strategy)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in ("_inner", "user_defined_strategy"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


class Fleet:
    def __init__(self):
        self._is_initialized = False
        self._strategy: Optional[DistributedStrategy] = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Collective mode (fleet_base.py:130): set up the world
        (``init_parallel_env``) and its hybrid mesh from ``strategy``
        (a default one when None). Parameter-server mode raises."""
        if not is_collective:
            raise NotImplementedError(
                "fleet.init: parameter-server mode is not ported; use "
                "is_collective=True")
        strategy = strategy or DistributedStrategy()
        hc = strategy.hybrid_configs
        dp, mp = int(hc["dp_degree"]), int(hc["mp_degree"])
        pp, sp = int(hc["pp_degree"]), int(hc["sp_degree"])
        if strategy.tensor_parallel and mp == 1:
            mp = int(strategy.tensor_parallel_configs[
                "tensor_parallel_degree"])
        world = comm.get_world_size()
        if dp == 1 and world % (mp * pp * sp) == 0:
            # dp fills whatever the other degrees leave (reference fleet
            # infers dp from the world; an explicit dp_degree overrides)
            dp = world // (mp * pp * sp)
        comm.init_hybrid_mesh(dp=dp, mp=mp, pp=pp, sp=sp)
        self._strategy = strategy
        self._is_initialized = True
        return self

    @property
    def is_initialized(self):
        return self._is_initialized

    def _require_init(self):
        if not self._is_initialized:
            raise RuntimeError("call fleet.init() first")

    # -- role and topology (fleet_base.py worker API) --------------------
    def worker_index(self):
        return comm.get_rank()

    def worker_num(self):
        return comm.get_world_size()

    def is_first_worker(self):
        return self.worker_index() == 0

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def worker_endpoints(self, to_string=False):
        eps = [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        collective.barrier()

    def stop_worker(self):
        return None

    def get_hybrid_communicate_group(self):
        """The topology of the job's mesh (``comm.hybrid_mesh()``: the
        fleet keeps no reference to its groups)."""
        self._require_init()
        return HybridCommunicateGroup(comm.mp_mesh())

    # -- the model and optimizer decorators ------------------------------
    def distributed_model(self, model):
        """``model`` wrapped for data parallelism over the mesh's dp x sp
        group (``DataParallel``: ranks start from that group's first rank's
        parameters, gradients are averaged over it at the end of each
        backward, ``shard_input`` takes this rank's part of a global
        batch). A ``DataParallel`` is returned as it is. A
        ``PipelineLayer`` becomes its ``PipelineParallel`` (pp above 1),
        with the reference's refusals (distributed/fleet/base.py:681)."""
        from ..pipeline import PipelineLayer, PipelineParallel

        self._require_init()
        mesh = comm.mp_mesh()
        if isinstance(model, PipelineLayer):
            if mesh.shape["pp"] == 1:
                raise ValueError(
                    "PipelineLayer needs hybrid_configs pp_degree > 1")
            pc = self._strategy.pipeline_configs
            return PipelineParallel(
                model, mesh=mesh,
                accumulate_steps=int(pc["accumulate_steps"]),
                schedule_mode=str(pc.get("schedule_mode", "1F1B")))
        if mesh.shape["pp"] > 1:
            raise ValueError(
                "pp_degree > 1 requires the model to be a "
                "distributed.PipelineLayer (stage partition; the "
                "device_guard analog)")
        if isinstance(model, DataParallel):
            return model
        return DataParallel(model, group=mesh.group("data"))

    def distributed_optimizer(self, optimizer, strategy=None):
        """``optimizer`` carrying the strategy of :meth:`init` (or
        ``strategy``, which then replaces it)."""
        self._require_init()
        if strategy is not None:
            self._strategy = strategy
        return _DistributedOptimizer(optimizer, self._strategy)


fleet = Fleet()
