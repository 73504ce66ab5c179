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
the batch over dp and the sequence (axis 1) over sp.

**The optimizer options** (counterpart of ``paddle_tpu/distributed/fleet/
base.py:72-556, 743-870``). ``distributed_optimizer`` makes the JAX
package's checks and swaps: ``a_sync`` (parameter-server mode) and
``sharding`` with ``hybrid_dp`` raise; ``lamb`` swaps an Adam/AdamW inner
optimizer for ``Lamb`` (``lamb_configs``; ``exclude_from_weight_decay``
tags match a parameter's name, or its ``named_parameters()`` name where
it has none, as ``Lars`` does), ``lars`` a ``Momentum`` for ``Lars``, and
a wrong inner optimizer raises ``ValueError``; an option of
``NOT_PORTED`` (``elastic_reshard``) raises ``NotImplementedError``
naming ROADMAP part 6. The returned :class:`_DistributedOptimizer`
applies ZeRO (``sharding``, stages 1-3) and ``gradient_merge`` in its
update (its notes), through ``jit.TrainStep`` and
``PipelineParallel.train_batch``; its eager ``step()`` merges and casts
the gradients on ``.grad`` and runs the inner step, unsharded (the
reference's semantics).

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
fails that check), no ``fp16_allreduce`` and no ``sharding`` (narrow
moments are not sharded: their blocks run along the last axis, which a
shard may cut), and arm ``quantize_moments``.
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


def _zero_plan(shape, n: int):
    """The axis ZeRO shards a leaf of ``shape`` on over ``n`` ranks (the
    JAX package's ``_zero_constrain`` / ``_leaf_pad_plan`` rule): the first
    axis that ``n`` divides; else, for a leaf of 1024 elements or more,
    its largest axis, padded to a multiple of ``n``; else None (the leaf
    stays replicated: a shard of less than one tile costs more in
    collective latency than it saves)."""
    shape = [int(d) for d in shape]
    for a, d in enumerate(shape):
        if d > 0 and d % n == 0:
            return a
    size = 1
    for d in shape:
        size *= d
    if shape and size >= 1024:
        return max(range(len(shape)), key=lambda a: shape[a])
    return None


class _ZeroShard:
    """How ZeRO shards one parameter over the dp ``group`` (``p.
    _zero_shard``): along ``axis`` of its logical shape ``full_shape``,
    padded with zeros to ``n`` equal parts (``padded``) where ``n`` does
    not divide it; this rank keeps part ``rank`` (``shard_shape``).
    ``scatter`` (stage 2 and 3): its gradient is reduce-scattered, and
    this rank's part of the mean lands in ``grad``."""

    def __init__(self, shape, axis: int, group, scatter: bool):
        self.full_shape = tuple(int(d) for d in shape)
        self.axis, self.group = int(axis), group
        self.n, self.rank = group.nranks, group.rank
        self.logical = self.full_shape[self.axis]
        self.size = -(-self.logical // self.n)
        self.padded = self.size * self.n
        sh = list(self.full_shape)
        sh[self.axis] = self.size
        self.shard_shape = tuple(sh)
        self.numel = 1
        for d in sh:
            self.numel *= d
        self.scatter = bool(scatter)
        self.grad = None

    def _pad(self, t: torch.Tensor) -> torch.Tensor:
        if self.padded == self.logical:
            return t
        widths = [0, 0] * (t.dim() - 1 - self.axis) + \
            [0, self.padded - self.logical]
        return torch.nn.functional.pad(t, widths)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a logical tensor, a new one."""
        return self._pad(full).narrow(
            self.axis, self.rank * self.size, self.size).clone(
            memory_format=torch.contiguous_format)

    def rows(self, full: torch.Tensor) -> torch.Tensor:
        """A logical tensor as ``[n, shard numel]``: row ``r`` is rank
        ``r``'s part, flat (the reduce-scatter's layout)."""
        return self._pad(full).unflatten(self.axis, (self.n, self.size)) \
            .movedim(self.axis, 0).reshape(self.n, -1)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The logical tensor from every rank's ``shard`` (a collective
        over the group)."""
        parts = collective.all_gather_(shard.detach().contiguous(),
                                       self.group)
        full = parts.movedim(0, self.axis).flatten(self.axis, self.axis + 1)
        return full.narrow(self.axis, 0, self.logical)


def _select(cond, new, old):
    """``where(cond, new, old)``; a float8 tensor selects on its bytes."""
    from .. import quantized_comm as qc

    return qc.from_bits(torch.where(cond, qc.bits(new), qc.bits(old)),
                        new.dtype)


def _grad_of(p):
    """``p``'s gradient: its ZeRO shard of the mean where the reduction
    scattered it (``_zero_shard.grad``, taken), else ``p.grad``."""
    zs = getattr(p, "_zero_shard", None)
    if zs is not None and zs.grad is not None:
        g, zs.grad = zs.grad, None
        return g
    return p.grad


class _DistributedOptimizer:
    """The user's optimizer with the strategy attached: every attribute
    but its own (``user_defined_strategy``, ``_quant_explicit``, the
    merge counter ``_gm_cnt`` and the stage-3 rebinding ``_rebind``) is
    read from and written to the inner optimizer (``_step_count``,
    ``_lr``, the accumulators). Each strategy option composes into the
    update (counterpart of ``paddle_tpu/distributed/fleet/base.py:
    72-556``):

    * **The gradient width.** ``fp16_allreduce`` / ``quantized_allreduce``
      cast the gradients once: in :meth:`_functional_update` (after the
      clip) and in :meth:`step` (before it), as the JAX package does.
    * **ZeRO** (``sharding``, stage 1-3, over the dp group). Each
      parameter gets a :class:`_ZeroShard` (:meth:`_apply_zero_padding`):
      this rank keeps the optimizer state of its shard only, updates that
      shard of the parameter and all-gathers the parameter. At stage 2
      the gradients are reduce-scattered (``parallel.reduce_gradients``);
      at stage 3 the parameter itself is held as its shard between steps
      and gathered for the step (:meth:`_zero_gather`), all of it at the
      step's start. Every norm over a whole tensor (the global-norm clip,
      ``Lamb``'s and ``Lars``' trust ratios, the guard's gradient norm)
      sums a shard's squares over the group. ``state_dict`` exports the
      accumulators at their logical shapes and ``set_state_dict`` takes
      them so (collectives over the group).
    * **Gradient merge** (``gradient_merge``, ``k_steps``, ``avg``). In
      :meth:`_functional_update` a merge buffer (``@gm_buf``, an
      accumulator like the value) and a counter (``_gm_cnt``, a 0-dim
      int32 tensor on the device) join the update: every call adds its
      gradients to the buffer, and every k-th call applies the inner rule
      to the merged (averaged) gradients, with the bias correction
      counting applied updates (``t = (cnt + 1) // k``); parameters,
      moments and the buffer change only at the boundary (``where`` on the
      device). The buffer and the counter are entries of the update, so
      a step the guard or the loss scaler skips leaves them unchanged too.
      The eager :meth:`step` keeps the reference's semantics instead: the
      gradients accumulate on ``.grad`` and the inner step runs at the
      boundary.
    """

    _OWN = ("_inner", "user_defined_strategy", "_quant_explicit",
            "_gm_cnt", "_rebind")

    def __init__(self, optimizer, strategy: DistributedStrategy):
        object.__setattr__(self, "_inner", optimizer)
        object.__setattr__(self, "user_defined_strategy", strategy)
        # set by jit.TrainStep around its update when its explicit dcn
        # hop quantizes the gradients: the boundary round trip then stands
        # down (quantizing twice would double the error)
        object.__setattr__(self, "_quant_explicit", False)
        object.__setattr__(self, "_gm_cnt", None)
        object.__setattr__(self, "_rebind", [])

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)

    # -- the strategy's pieces -------------------------------------------
    @property
    def _gm_k(self) -> int:
        s = self.user_defined_strategy
        return int(s.gradient_merge_configs["k_steps"]) \
            if s.gradient_merge else 1

    @property
    def _gm_avg(self) -> bool:
        return bool(self.user_defined_strategy.gradient_merge_configs["avg"])

    @property
    def _sharding_stage(self) -> int:
        s = self.user_defined_strategy
        return int(s.sharding_configs["stage"]) if s.sharding else 0

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

    # -- ZeRO --------------------------------------------------------------
    def _zero_group(self):
        """The group ZeRO shards over (the dp group: per pipeline stage,
        and the dcn x ici pair on a hierarchical mesh), or None."""
        if self._sharding_stage < 1:
            return None
        g = comm.dp_group()
        return g if g is not None and g.nranks > 1 else None

    def _apply_zero_padding(self, params) -> None:
        """ZeRO's layout of ``params``: each that :func:`_zero_plan`
        shards gets its :class:`_ZeroShard`; at stage 3 its storage
        becomes this rank's shard (padded where the axis does not divide)
        until :meth:`_zero_gather`."""
        g = self._zero_group()
        if g is None:
            return
        stage = self._sharding_stage
        for p in params:
            if getattr(p, "_zero_shard", None) is not None:
                continue
            axis = _zero_plan(p.shape, g.nranks)
            if axis is None:
                continue
            zs = _ZeroShard(p.shape, axis, g, scatter=stage >= 2)
            p._zero_shard = zs
            if stage >= 3:
                with torch.no_grad():
                    p.data = zs.take(p.data)

    def _zero_gather(self, params) -> None:
        """Stage 3: each parameter held as its shard gathered back to its
        logical value, for the step (a collective over the dp group)."""
        if self._sharding_stage < 3:
            return
        for p in params:
            zs = getattr(p, "_zero_shard", None)
            if zs is not None and tuple(p.shape) == zs.shard_shape:
                with torch.no_grad():
                    p.data = zs.gather(p.data)

    def _zero_values(self, params, grads):
        """(values, gradients) of the sharded update: this rank's shard of
        each ZeRO parameter and of its gradient (a stage-2/3 gradient is
        one already); a replicated parameter is its own value. Stage 3
        notes each shard for :meth:`_write` to rebind."""
        self._apply_zero_padding(params)
        store = self._inner._accumulators
        values, out = [], []
        self._rebind = []
        for p, g in zip(params, grads):
            zs = getattr(p, "_zero_shard", None)
            if zs is None:
                values.append(p)
                out.append(g)
                continue
            for acc in store.values():
                # state loaded at the logical shape (set_state_dict)
                v = acc.get(id(p))
                if v is not None and tuple(v.shape) == zs.full_shape \
                        and zs.full_shape != zs.shard_shape:
                    acc[id(p)] = zs.take(v)
            v = p.detach().clone() if tuple(p.shape) == zs.shard_shape \
                else zs.take(p.detach())
            values.append(v)
            out.append(g if g is None or tuple(g.shape) == zs.shard_shape
                       else zs.take(g))
            if self._sharding_stage >= 3:
                self._rebind.append((p, v))
        return values, out

    def _zero_finish(self, params, values, news):
        """Stage 1 and 2: each updated shard all-gathered into its
        parameter's full new value (the write's target the parameter)."""
        if self._sharding_stage >= 3:
            return news
        owner = {id(v): p for p, v in zip(params, values)}
        out = []
        for tgt, new, accs, new_accs in news:
            p = owner.get(id(tgt))
            zs = getattr(p, "_zero_shard", None)
            if zs is None or p is tgt:
                out.append((tgt, new, accs, new_accs))
            else:
                out.append((p, zs.gather(new).to(p.dtype), accs, new_accs))
        return out

    @staticmethod
    def _logical(v, zs):
        """A sharded accumulator at its logical shape (a collective)."""
        return zs.gather(v) if tuple(v.shape) == zs.shard_shape else v

    # -- gradient merge ------------------------------------------------------
    def _gm_counter(self, device):
        if self._gm_cnt is None:
            self._gm_cnt = torch.zeros((), dtype=torch.int32, device=device)
        return self._gm_cnt

    def _merge_update(self, params, grads, lr, values):
        """The merged update (the class notes): the inner rule's entries
        selected at the boundary, plus the buffer's and the counter's."""
        inner, k = self._inner, self._gm_k
        vals = params if values is None else values
        live = [(p, v, g) for p, v, g in zip(params, vals, grads)
                if g is not None]
        if not live:
            return []
        cnt = self._gm_counter(live[0][1].device)
        boundary = torch.remainder(cnt + 1, k) == 0
        scale = 1.0 / k if self._gm_avg else 1.0
        bufs, merged = [], []
        for p, v, g in zip(params, vals, grads):
            if g is None:
                merged.append(None)
                continue
            b = inner._acc("@gm_buf", p, like=v)
            nb = b + g.to(b.dtype)
            bufs.append((b, nb))
            merged.append((nb * scale).to(nb.dtype))
        t_inner = torch.div(cnt + 1, k, rounding_mode="floor").float()
        news = self._inner_update(params, merged, lr, t_inner, values)
        out = []
        for (tgt, new, accs, new_accs), (b, nb) in zip(news, bufs):
            sel = {n: _select(boundary, new_accs[n], accs[n])
                   for n in new_accs}
            sel["@gm_buf"] = torch.where(boundary, torch.zeros_like(nb), nb)
            out.append((tgt, _select(boundary, new, tgt),
                        {**accs, "@gm_buf": b}, sel))
        out.append((cnt, cnt + 1, {}, {}))
        return out

    # -- the update ----------------------------------------------------------
    @torch.no_grad()
    def _functional_update(self, params, grads, lr, t):
        """The inner rule's entries for :meth:`_write`, through the
        strategy: the width cast, ZeRO's shards and gradient merge."""
        width = self._comm_width_cast()
        if width is not None:
            grads = [g if g is None else width(g) for g in grads]
        values = None
        if self._zero_group() is not None:
            values, grads = self._zero_values(params, grads)
        if self._gm_k > 1:
            news = self._merge_update(params, grads, lr, values)
        else:
            news = self._inner_update(params, grads, lr, t, values)
        if values is not None:
            news = self._zero_finish(params, values, news)
        return news

    def _inner_update(self, params, grads, lr, t, values):
        if values is None:  # the rule of a subclass that takes no values
            return self._inner._functional_update(params, grads, lr, t)
        return self._inner._functional_update(params, grads, lr, t,
                                              values=values)

    @torch.no_grad()
    def _write(self, news, ok=None) -> None:
        """The inner write, then (stage 3) each parameter rebound to its
        shard."""
        self._inner._write(news, ok)
        for p, v in self._rebind:
            p.data = v
        self._rebind = []

    def state_dict(self):
        """The inner state with every ZeRO-sharded accumulator at its
        parameter's logical shape (the JAX package's checkpoint contract:
        a snapshot restores into any sharding; a collective over the dp
        group), and under gradient merge ``"@step"`` the applied
        updates."""
        from ...core.tensor import Tensor

        out = self._inner.state_dict()
        name_of = self._inner._state_names()
        for p in self._inner._get_params():
            zs = getattr(p, "_zero_shard", None)
            if zs is None:
                continue
            for acc_name, store in self._inner._accumulators.items():
                v = store.get(id(p))
                if v is not None:
                    out[f"{name_of[id(p)]}.{acc_name}"] = Tensor._wrap(
                        self._logical(v, zs))
        if self._gm_k > 1 and self._gm_cnt is not None:
            out["@step"] = int(self._gm_cnt) // self._gm_k
        return out

    def set_state_dict(self, state) -> None:
        """A ``state_dict`` at logical shapes (of any sharding): the
        accumulators are cut to this rank's shards at the next update."""
        self._inner.set_state_dict(state)
        if self._gm_k > 1:
            dev = self._inner._get_params()[0].device
            self._gm_cnt = torch.tensor(
                int(state.get("@step", 0)) * self._gm_k, dtype=torch.int32,
                device=dev)

    set_dict = set_state_dict

    # -- the eager path ------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """The eager update from ``.grad`` (reference ``base.py:516``):
        under gradient merge a call off the boundary only counts (the
        gradients keep accumulating on ``.grad``); at the boundary the
        gradients are averaged (``avg``), cast once to the comm width, the
        inner optimizer steps, and the gradients are cleared. ZeRO shards
        the update inside ``jit.TrainStep`` and ``train_batch`` only, as
        the JAX package does."""
        k = self._gm_k
        params = [p for p in self._inner._get_params() if p.grad is not None]
        if k > 1:
            cnt = self._gm_counter(params[0].device if params else "cpu")
            cnt.add_(1)
            if int(cnt) % k != 0:
                return None
            if self._gm_avg:
                for p in params:
                    p.grad.div_(k)
        width = self._comm_width_cast()
        if width is not None:
            for p in params:
                p.grad.copy_(width(p.grad))
        out = self._inner.step()
        if k > 1:
            self._inner.clear_grad()
        return out

    def clear_grad(self):
        """Clears the gradients, except mid-merge: they must survive
        until the boundary."""
        k = self._gm_k
        if k > 1 and self._gm_cnt is not None and int(self._gm_cnt) % k:
            return None
        return self._inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The eager ``minimize`` through :meth:`step` (the width cast and
        gradient merge apply); a symbolic loss is the inner optimizer's to
        record."""
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

        from ...optimizer import Adam, AdamW, Lamb, Lars, Momentum
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
        if s.a_sync:
            raise NotImplementedError(
                "a_sync is parameter-server mode, which the port does not "
                "run (fleet.init takes is_collective=True only)")
        if s.sharding and s.sharding_configs["hybrid_dp"]:
            raise NotImplementedError(
                "sharding hybrid_dp (sharding groups x dp groups) is not "
                "built; state shards over the FULL dp axis here "
                "(equivalent to sharding_degree == dp_degree)")
        unported = s.not_ported()
        if unported:
            raise NotImplementedError(
                f"strategy options {unported} are not ported yet (ROADMAP "
                "queue A item 7, part 6: the elastic launcher and "
                "resharding)")
        if s.quantized_matmul:
            qcp.resolve_matmul(s.quantized_matmul)
        if s.lamb:
            # the LambOptimizer meta-optimizer: the inner must be
            # Adam-family (fleet/meta_optimizers/lamb_optimizer.py:20)
            if not isinstance(optimizer, (Adam, AdamW)):
                raise ValueError(
                    "strategy.lamb swaps an Adam/AdamW inner optimizer for "
                    f"Lamb; got {type(optimizer).__name__}")
            cfg = s.lamb_configs
            excl = list(cfg["exclude_from_weight_decay"])
            swapped = Lamb(
                learning_rate=optimizer._lr,
                lamb_weight_decay=float(cfg["lamb_weight_decay"]),
                beta1=optimizer._beta1, beta2=optimizer._beta2,
                parameters=optimizer._parameter_list,
                grad_clip=optimizer._grad_clip)
            if excl:
                swapped._exclude_fn = lambda p: any(
                    tag in swapped._param_name(p) for tag in excl)
            swapped._names.update(optimizer._names)
            optimizer = swapped
        elif s.lars:
            # lars_optimizer.py:19: the inner must be Momentum
            if not isinstance(optimizer, Momentum):
                raise ValueError(
                    "strategy.lars swaps a Momentum inner optimizer for "
                    f"Lars; got {type(optimizer).__name__}")
            cfg = s.lars_configs
            swapped = Lars(
                learning_rate=optimizer._lr, momentum=optimizer._momentum,
                lars_coeff=float(cfg["lars_coeff"]),
                lars_weight_decay=float(cfg["lars_weight_decay"]),
                epsilon=float(cfg["epsilon"]),
                parameters=optimizer._parameter_list,
                grad_clip=optimizer._grad_clip,
                exclude_from_weight_decay=list(
                    cfg["exclude_from_weight_decay"]))
            swapped._names.update(optimizer._names)
            optimizer = swapped
        if s.quantized_moments:
            # after the swaps: a Lamb-swapped inner fails the family check
            if s.fp16_allreduce:
                raise ValueError(
                    "quantized_moments cannot combine with fp16_allreduce: "
                    "the grad would pass two lossy width policies back to "
                    "back on the grad->moment path (bf16 comm round trip, "
                    "then the int8 moment round trip) — use "
                    "quantized_allreduce for narrow comm instead")
            if not isinstance(optimizer, (Adam, AdamW)):
                raise ValueError(
                    "strategy.quantized_moments stores Adam-family "
                    "moment1/moment2 state narrow; got "
                    f"{type(optimizer).__name__}")
            if s.sharding:
                raise NotImplementedError(
                    "quantized_moments with sharding: the port does not "
                    "shard narrow moments (their blocks run along the last "
                    "axis, which a shard may cut)")
            optimizer.quantize_moments(s.quantized_moments)
        return _DistributedOptimizer(optimizer, self._strategy)


fleet = Fleet()
