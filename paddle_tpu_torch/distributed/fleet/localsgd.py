"""LocalSGD: local updates on each rank and a periodic average of the
parameters (counterpart of ``paddle_tpu/distributed/fleet/localsgd.py``).

Reference: fleet/meta_optimizers/localsgd_optimizer.py:23 (LocalSGD): each
worker steps on its own and every ``k_steps`` the workers average their
parameters (c_allreduce_sum / nranks), in place of the per-step gradient
all-reduce.

The JAX package stacks the workers' diverging parameters on a leading dp
axis inside one ``shard_map`` program. A rank of the port is a process,
so each rank simply keeps its own parameters: :class:`LocalSGDStep` is
``jit.TrainStep`` with the gradient reduction left out (a
``DataParallel`` model's backward runs under its ``no_sync``) and, at a
sync step (``t >= begin_step`` and ``t % k_steps == 0``, ``t`` the
optimizer's step count), each new parameter and buffer averaged over the
dp group before the guard's mask writes it: a step the guard skips skips
the average too, as the JAX package masks after its ``pmean``. The loss
is the dp mean, and the guard's verdict is agreed over the world, so
every rank skips together. ``TrainStep(model, loss_fn, opt)`` with a
``localsgd`` strategy returns this step. While the step lives,
``model.state_dict()`` averages the parameters, buffers and optimizer
state over dp first (:meth:`LocalSGDStep.sync_to_model`), so a checkpoint
holds the averaged weights, as the JAX package's does. After a local step
that sync is a collective: every dp rank takes the state (or calls
``sync_to_model()``) together, and then any rank may save it. Once the
step is gone, ``model.state_dict`` is the model's own again.
"""
from __future__ import annotations

import contextlib
import weakref

import torch

from ...jit.train_step import TrainStep
from .. import collective, comm

__all__ = ["LocalSGDStep"]


class LocalSGDStep(TrainStep):
    """``TrainStep`` under LocalSGD (the module's notes). ``k_steps`` and
    ``begin_step`` default to the strategy's ``localsgd_configs``. Pure
    data parallelism only: a mesh with mp, pp or sp above 1 raises, as
    do amp, recompute and the options that reduce or shard gradients
    (``TrainStep``'s refusals). The update is the inner optimizer's
    rule."""

    def __init__(self, model, loss_fn, optimizer, *, k_steps=None,
                 begin_step=None, return_outputs: bool = False):
        mesh = comm.hybrid_mesh()
        if mesh is not None and any(
                mesh.shape[a] != 1 for a in ("mp", "pp", "sp")):
            raise NotImplementedError(
                "localsgd composes with pure data parallelism only")
        s = getattr(optimizer, "user_defined_strategy", None)
        cfg = s.localsgd_configs if s is not None else {}
        self.k_steps = int(k_steps if k_steps is not None
                           else cfg.get("k_steps", 1))
        self.begin_step = int(begin_step if begin_step is not None
                              else cfg.get("begin_step", 1))
        super().__init__(model, loss_fn, optimizer,
                         return_outputs=return_outputs)
        # LocalSGD owns the comm schedule: the inner rule updates
        self.opt = getattr(optimizer, "_inner", optimizer)
        self._dirty = False
        self._group = comm.dp_group()
        _sync_state_dict(model, self)

    def _world_plan(self, model, return_outputs):
        plan = super()._world_plan(model, return_outputs)
        return None if plan is None else (plan[0], plan[1], False)

    def _hop_guard(self):
        """The backward pass: a ``DataParallel`` model's reduction off."""
        no_sync = getattr(self.model, "no_sync", None)
        return no_sync() if no_sync is not None \
            else contextlib.nullcontext()

    def _sync_now(self) -> bool:
        t = int(self.opt._step_count)
        return t >= self.begin_step and t % self.k_steps == 0

    def _averaging(self) -> bool:
        g = self._group
        return g is not None and g.nranks > 1

    @torch.no_grad()
    def _before_write(self, news) -> None:
        """At a sync step: each new parameter (and the forward's buffers)
        averaged over dp, before the guard's masked write."""
        self._dirty = True
        if not (self._sync_now() and self._averaging()):
            return
        for _, new_p, _, _ in news:
            collective.all_reduce_(new_p, collective.ReduceOp.AVG,
                                   self._group)
        for b in self._buffers:
            if b.is_floating_point():
                collective.all_reduce_(b, collective.ReduceOp.AVG,
                                       self._group)
        self._dirty = False

    @torch.no_grad()
    def sync_to_model(self) -> None:
        """Average the parameters, the buffers and the optimizer's
        accumulators over dp (a collective), once after any local step."""
        if not self._dirty or not self._averaging():
            self._dirty = False
            return
        tensors = list(self._params) + [b for b in self._buffers
                                        if b.is_floating_point()]
        for store in self.opt._accumulators.values():
            tensors += [v for v in store.values()
                        if v.is_floating_point()]
        for t in tensors:
            collective.all_reduce_(t.data, collective.ReduceOp.AVG,
                                   self._group)
        self._dirty = False


def _sync_state_dict(model, step: LocalSGDStep) -> None:
    """``model.state_dict`` syncs ``step`` first (reference
    ``localsgd.py:119-124``) for as long as ``step`` lives; its first call
    after that puts back what ``model.state_dict`` was before."""
    prev = model.__dict__.get("state_dict")
    # an earlier step's wrapper gives way to this one
    prev = getattr(prev, "_localsgd_prev", prev)
    ref = weakref.ref(step)

    def state_dict(*a, **kw):
        live = ref()
        if live is not None:
            live.sync_to_model()
        elif model.__dict__.get("state_dict") is state_dict:
            if prev is None:
                del model.__dict__["state_dict"]
            else:
                model.__dict__["state_dict"] = prev
        own = prev if prev is not None else type(model).state_dict.__get__(
            model)
        return own(*a, **kw)

    state_dict._localsgd_prev = prev
    model.__dict__["state_dict"] = state_dict
