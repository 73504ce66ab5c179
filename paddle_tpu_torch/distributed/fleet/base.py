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

**Gradient width** (counterpart of ``paddle_tpu/distributed/fleet/
base.py:277-335, 596-623, 743-870``). ``hierarchical_allreduce`` factors
dp into dcn x ici at ``fleet.init`` (``hierarchical_allreduce_inter_
nranks``; 0 takes dp's largest proper divisor, and a dp with none raises).
``fp16_allreduce`` and ``quantized_allreduce`` are width policies at the
optimizer's boundary: the reduced float32 gradient passes one bfloat16
round trip (``_comm_cast``) or one pass through the block quantizer
(``_quant_cast``) before the update, unless ``TrainStep``'s explicit dcn
hop does the quantizing (``_quant_explicit``, set around that step's
update only). The value that enters the
update passes exactly one rounding; the wire of those boundary policies
stays float32 (as in the JAX package, whose compiler places the
reduction). ``distributed_optimizer`` makes the JAX package's checks:
``dgc`` with ``fp16_allreduce`` raises and ``dgc`` alone becomes
``quantized_allreduce="int8"``; two width policies raise; a
``quantized_matmul`` or ``quantized_moments`` typo raises; quantized
moments need an Adam-family optimizer (after the ``lamb`` swap, which
fails that check) and no ``fp16_allreduce``, and arm
``quantize_moments``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

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
    but its own (``user_defined_strategy``, ``_quant_explicit``) is read
    from and written to the inner optimizer (``_step_count``, ``_lr``,
    the accumulators). The gradient-width policy applies where the JAX
    package applies it: in :meth:`_functional_update` (``TrainStep``,
    after the clip) and in :meth:`step` (before the inner step)."""

    _OWN = ("_inner", "user_defined_strategy", "_quant_explicit")

    def __init__(self, optimizer, strategy: DistributedStrategy):
        object.__setattr__(self, "_inner", optimizer)
        object.__setattr__(self, "user_defined_strategy", strategy)
        # set by jit.TrainStep around its update when its explicit dcn
        # hop quantizes the gradients: the boundary round trip then stands
        # down (quantizing twice would double the error)
        object.__setattr__(self, "_quant_explicit", False)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)

    # -- the gradient-width policies -------------------------------------
    @property
    def _fp16_allreduce(self) -> bool:
        return bool(self.user_defined_strategy.fp16_allreduce)

    @property
    def _quant_policy(self):
        """``quantized_allreduce`` as a resolved (dtype, block) pair, or
        None."""
        from .. import quantized_comm as qc

        s = self.user_defined_strategy
        return qc.resolve_policy(s.quantized_allreduce,
                                 s.quantized_allreduce_block)

    @staticmethod
    def _comm_cast(g):
        """``fp16_allreduce``: the reduced float32 gradient rounded to
        bfloat16 and back (the value a bfloat16 reduction delivers);
        other types pass as they are."""
        if g.dtype != torch.float32:
            return g
        return g.to(torch.bfloat16).to(torch.float32)

    def _quant_cast(self, g):
        """``quantized_allreduce`` at the boundary: the float32 gradient
        through the block quantizer once; other types pass as they
        are."""
        from .. import quantized_comm as qc

        if g.dtype != torch.float32:
            return g
        dtype, block = self._quant_policy
        return qc.quantize_dequantize(g, dtype, block)

    def _comm_width_cast(self):
        """The active width policy's cast, or None (``fp16_allreduce`` and
        ``quantized_allreduce`` never both: ``distributed_optimizer``
        refuses that)."""
        if self._fp16_allreduce:
            return self._comm_cast
        if self._quant_policy is not None and not self._quant_explicit:
            return self._quant_cast
        return None

    def _functional_update(self, params, grads, lr, t):
        cast = self._comm_width_cast()
        if cast is not None:
            grads = [g if g is None else cast(g) for g in grads]
        return self._inner._functional_update(params, grads, lr, t)

    def step(self):
        cast = self._comm_width_cast()
        if cast is not None:
            with torch.no_grad():
                for p in self._inner._get_params():
                    if p.grad is not None:
                        p.grad.copy_(cast(p.grad))
        return self._inner.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The eager ``minimize`` through :meth:`step` (the width cast
        applies); a symbolic loss is the inner optimizer's to record."""
        from ...static.program import static_var

        if static_var(loss) is not None:
            return self._inner.minimize(loss, startup_program, parameters,
                                        no_grad_set)
        if parameters is not None:
            self._inner._set_parameters(parameters)
        if not getattr(loss, "_backward_ran", False):
            loss.backward()
        self.step()
        return None, None


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
        ici = 1
        if strategy.hierarchical_allreduce and dp > 1:
            ici = int(strategy.hierarchical_allreduce_inter_nranks)
            if ici <= 0:
                # the largest proper divisor of dp: two real levels; a
                # prime dp has no two-level factoring and fails loudly
                ici = next((d for d in range(dp // 2, 1, -1)
                            if dp % d == 0), 0)
                if ici < 2:
                    raise ValueError(
                        f"hierarchical_allreduce: dp_degree={dp} has no "
                        "two-level factoring (prime or 2); set "
                        "hierarchical_allreduce_inter_nranks explicitly "
                        "or disable the flag")
            if dp % ici:
                raise ValueError(
                    f"hierarchical_allreduce_inter_nranks={ici} must "
                    f"divide dp_degree={dp}")
        comm.init_hybrid_mesh(dp=dp, mp=mp, pp=pp, sp=sp, dp_inner=ici)
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
        ``strategy``, which then replaces it), after the JAX package's
        checks of the width and quantization options (the module's
        notes). ``quantized_moments`` arms the optimizer's
        ``quantize_moments``."""
        import warnings

        from ...optimizer import Adam, AdamW
        from .. import quantized_comm as qc
        from .. import quantized_compute as qcp

        self._require_init()
        if strategy is not None:
            self._strategy = strategy
        s = self._strategy
        if s.dgc and s.fp16_allreduce:
            raise ValueError(
                "dgc routes to the quantized_allreduce grad-comm width "
                "policy, which cannot combine with fp16_allreduce — drop "
                "one of dgc/fp16_allreduce")
        if s.dgc:
            # DGC's top-k sparsified allreduce is not built; its goal,
            # fewer gradient bytes, is what the quantized allreduce gives
            warnings.warn(
                "strategy.dgc (top-k sparsified allreduce) is deprecated: "
                "routing to the block-scaled quantized allreduce policy "
                "(strategy.quantized_allreduce='int8')",
                DeprecationWarning, stacklevel=2)
            if not s.quantized_allreduce:
                s.quantized_allreduce = "int8"
        if s.quantized_allreduce:
            qc.resolve_policy(s.quantized_allreduce,
                              s.quantized_allreduce_block)
            if s.fp16_allreduce:
                raise ValueError(
                    "fp16_allreduce and quantized_allreduce are both "
                    "grad-comm width policies — enable one, not both")
        if s.quantized_matmul:
            qcp.resolve_matmul(s.quantized_matmul)
        if s.quantized_moments:
            # lamb (which would swap Adam for Lamb) is not ported and
            # raises in TrainStep; the family check runs on what trains
            if s.fp16_allreduce:
                raise ValueError(
                    "quantized_moments cannot combine with fp16_allreduce: "
                    "the grad would pass two lossy width policies back to "
                    "back on the grad->moment path (bf16 comm round trip, "
                    "then the int8 moment round trip) — use "
                    "quantized_allreduce for narrow comm instead")
            if s.lamb or not isinstance(optimizer, (Adam, AdamW)):
                raise ValueError(
                    "strategy.quantized_moments stores Adam-family "
                    "moment1/moment2 state narrow; got "
                    f"{'Lamb' if s.lamb else type(optimizer).__name__}")
            optimizer.quantize_moments(s.quantized_moments)
        return _DistributedOptimizer(optimizer, self._strategy)


fleet = Fleet()
