"""The training step: forward, loss, backward and the optimizer update in
one call (counterpart of ``paddle_tpu/jit/train_step.py``).

JAX compiles ``_step_fn`` into one XLA program; here the step runs
eagerly: the model's forward and ``loss_fn`` under autograd, one
``backward()`` (through the kernels' autograd Functions, so the B3/B4/B7
backward kernels run), the regularizer terms and the gradient clip
(``optimizer._process_grads``), then the update of
``optimizer._functional_update`` with the guard's mask. Parameters without
a gradient (off the loss's graph) keep their values and state, as in
JAX's ``_used_mask``. The learning rate is read from the optimizer (its
``LRScheduler``, if it has one) at each call.

An optimizer from ``distributed.fleet.distributed_optimizer`` carries a
``DistributedStrategy``. With ``strategy.amp`` the forward and the loss
run under ``amp.auto_cast`` (bfloat16 O1 by default; O2 with
``use_pure_fp16``). float16 with dynamic loss scaling scales the loss
inside the step: the gradients are divided by the scale, a step whose
gradients (or, with the guard on, loss, gradients or new parameters) are
not finite leaves parameters and moments unchanged and counts as a bad
step, and the scale grows or backs off on the device, with no host read.
The bias correction then counts applied updates only.

The gradient-width and quantized-compute options (counterpart of
``paddle_tpu/jit/train_step.py:108-203, 260-346, 382``):
``quantized_matmul`` arms ``quantized_compute.matmul_scope`` around the
forward and the loss, so every wide linear weight trains through
``qat_matmul``; ``quantized_moments`` is the optimizer's (armed by
``fleet.distributed_optimizer``); ``fp16_allreduce`` and a
``quantized_allreduce`` without an explicit hop are the optimizer's
boundary casts. On a hierarchical mesh, ``async_dcn_allreduce``, or
``quantized_allreduce`` with ``hierarchical_allreduce``, makes the dcn hop
explicit (``_async_dcn``, its policy ``_dcn_quant``), as in the JAX
package: each gradient's dcn reduction starts in the step's backward pass
(``distributed.overlap.DcnGradHop``, whose ``manual_dcn`` extent a
``DataParallel`` model leaves alone) and completes before the clip, and
the optimizer's boundary round trip stands down for the step's update
(``_quant_explicit`` is set around it only: the model and the optimizer
keep no state of the step). ``async_dcn_allreduce`` without
``hierarchical_allreduce`` raises, and so does the
explicit hop with float16 dynamic loss scaling, with a model that has
buffers, or with ``return_outputs``. The static records
``_grad_comm_info`` (priced per hop on a hierarchical mesh),
``_q_matmul_info`` and ``_moment_bytes_info`` ride the ``step_metrics``
rows and go to the bus once (``grad_comm``, ``q_matmul``,
``moment_bytes``). The optimizer options are the optimizer's
(``fleet.distributed_optimizer``: ZeRO, gradient merge, the Lamb and Lars
swaps); the step holds a stage-3 parameter as its shard between calls and
gathers it at the start of each (``_zero_gather``), and takes a ZeRO
gradient shard where the reduction scattered one. With
``strategy.recompute`` the model's forward runs through
``jit.recompute`` (the JAX package's ``jax.checkpoint`` of
``_fwd_segment``): its activations are recomputed in backward, under the
step's AMP and quantized-matmul scopes, and its forward kernels launch
twice. A ``localsgd`` strategy makes ``TrainStep(...)`` return a
``fleet.localsgd.LocalSGDStep``, refused with amp or recompute and with
the options that reduce or shard gradients. ``elastic_reshard``, the one
option of ``NOT_PORTED``, raises ``NotImplementedError``.

The guard (``utils/train_guard.py``) runs unless ``PADDLE_GUARD_MODE=off``.
Each step computes its health word and folds it into the guard's state
vector (``update_guard_state``: the streak, the totals, the loss and
grad-norm EWMAs, spike detection under ``PADDLE_GUARD_SPIKE_FACTOR``),
all on the device, and masks parameters, moments and buffers with its
``ok_apply``: a step whose loss, gradients (or, with
``PADDLE_GUARD_CHECK_PARAMS=1``, new parameters) are not finite, or whose
grad norm spiked, leaves them bitwise unchanged, and a healthy step's
values are bitwise those of the step with the guard off. The guard's host
half (``TrainGuard``) reads the state vector every
``PADDLE_GUARD_SYNC_EVERY`` steps, one interval late, through a
``non_blocking`` copy into pinned memory; past ``PADDLE_GUARD_MAX_SKIPS``
consecutive bad steps it rolls back to the ``auto_checkpoint`` range's
last generation (then :meth:`TrainStep._after_rollback` refreshes the
state vector), raises, or exits 96 (``PADDLE_GUARD_MODE=abort``). As in
JAX the step count ``t`` of the bias correction advances on every call.

A ``PADDLE_FAULT_SPEC`` rule for the ``grad`` site (``grad:nan:3:2``)
multiplies that step's gradients in place by NaN, Inf or 1e4, after the
loss scale is divided out and before the clip. Each call also sets the
bus's step (``observability.bus.set_step``), crosses the profiler's
``step_boundary`` (the trace window), and names ``TrainStep::opt_update``
and ``TrainStep::guard`` on a trace. :meth:`TrainStep.flops_per_step`
counts one step's FLOPs on fake tensors (``observability/mfu.py``);
:meth:`TrainStep.mfu_pct` divides by a step time and the card's peak.
:meth:`TrainStep.state_dict` carries the loss scaler's state and the
guard's counters (register the step as an ``auto_checkpoint`` extra).

Buffers that the forward updates (batch norm's running statistics) are
masked with the same verdict: a skipped step leaves them bitwise
unchanged too, as the JAX package masks its ``new_b``. (With the guard
off, the JAX package masks them on neither skip; the port masks them on
the fp16 scaler's skip as well, so a non-finite batch never reaches the
running statistics.)

**Across a world of ranks** (``distributed``: a rank is a process), the
step makes explicit what the JAX package's one controller gives for free.
The gradients are averaged over the data group (dp, times sp on a mesh
with sequence parallelism, where each rank's loss covers its own tokens:
the mean of equal shards' mean losses is the global token mean) before
the loss scale is divided out and before the clip (by the model's
``DataParallel`` hooks, ``fleet.distributed_model``, or else by the step,
through ``distributed.parallel.reduce_gradients``); the global-norm clip
sums the tensor-parallel shards' squares over mp. The returned loss is
the mean over the data group, the same on every rank. The guard's verdict (its health bits and
grad norm, the norm over the full gradients) and the float16 scaler's
found-inf are reduced over the world with MAX before they mask the
update, so a step that one rank skips is skipped by all.

Not ported yet: ``grad_post_hook``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from .. import amp
from .. import profiler as _prof
from ..core.tensor import to_torch
from ..distributed.fleet.base import _grad_of
from ..distributed.fleet.strategy import DistributedStrategy
from ..observability import bus as _bus
from ..utils import fault_injection as _FI
from ..utils import train_guard as _TG

__all__ = ["TrainStep"]


#: the gradients' factor of each GRAD_POISONS code: [clean, nan, inf, spike]
_POISON = (1.0, float("nan"), float("inf"), 1e4)


@contextlib.contextmanager
def _explicit(opt):
    """``opt._quant_explicit`` set for the extent of the block."""
    prev, opt._quant_explicit = opt._quant_explicit, True
    try:
        yield
    finally:
        opt._quant_explicit = prev


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class TrainStep:
    """One training step per call::

        step = paddle_tpu_torch.jit.TrainStep(model, loss_fn, opt)
        loss = step(inputs, labels)      # tensors or numpy arrays

    ``loss_fn(model_outputs, *labels)`` returns a scalar loss tensor (a
    ``Tensor`` of the Paddle surface too: a model written with Paddle's
    ops runs as it is). Each
    call returns the loss, detached (and the detached outputs with
    ``return_outputs=True``); parameters' ``.grad`` is cleared after the
    update."""

    def __new__(cls, model=None, loss_fn=None, optimizer=None, **kwargs):
        # a localsgd strategy takes fleet.localsgd.LocalSGDStep's step
        s = getattr(optimizer, "user_defined_strategy", None)
        if cls is TrainStep and isinstance(s, DistributedStrategy) \
                and s.localsgd:
            from ..distributed.fleet.localsgd import LocalSGDStep

            cls = LocalSGDStep
        return super().__new__(cls)

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, *, return_outputs: bool = False):
        self._recompute = False       # strategy.recompute
        self._amp_ctx = None          # amp.auto_cast kwargs of the step
        self._loss_scale_cfg = None   # float16 dynamic loss scaling
        self._scaler_state = ()       # (scale, good, bad, applied) tensors
        self._quant_info = None       # quantized_allreduce's policy
        self._q_matmul = None         # quantized_matmul's policy
        self._async_dcn = False       # the dcn hop is explicit
        self._dcn_quant = None        # the explicit hop's policy
        self._hop = None              # overlap.DcnGradHop
        strategy = getattr(optimizer, "user_defined_strategy", None)
        if strategy is not None:
            self._read_strategy(strategy)
        self.model = model
        self.loss_fn = loss_fn
        self.opt = optimizer
        self._ret_out = return_outputs
        if optimizer._parameter_list is None:
            optimizer._set_parameters(model.named_parameters())
        self._params = [p for p in optimizer._get_params()
                        if p.requires_grad]
        self._buffers = list(model.buffers())
        self._device = self._params[0].device if self._params \
            else torch.device("cpu")
        if hasattr(optimizer, "_apply_zero_padding"):
            # ZeRO's layout: the shards (at stage 3, the storage too)
            optimizer._apply_zero_padding(self._params)
        if self._loss_scale_cfg is not None:
            self._scaler_state = self._scaler_tensors(
                self._loss_scale_cfg["init_loss_scaling"], 0, 0, 0)
        # the guard's host half; its state vector rides the step on the
        # device, read every PADDLE_GUARD_SYNC_EVERY steps
        mode = _TG.guard_mode()
        self._guard = _TG.TrainGuard(mode=mode, model=model) \
            if mode != "off" else None
        self._guard_state = None
        self._world_reduce = self._world_plan(model, return_outputs)
        if self._guard is not None:
            self._guard._on_rollback = self._after_rollback
            self._guard_state = _TG.init_guard_state(self._device)
        # the grad-poison fault site, decided once: a clean spec adds no op
        self._inject_enabled = _FI.has_site("grad")
        self._n_steps = 0
        self._example = None   # the first call's batch, for the FLOP count
        self._flops = None
        from ..distributed import comm as _comm
        from ..distributed import quantized_comm as _qc
        from ..distributed import quantized_compute as _qcp

        mesh = _comm.hybrid_mesh()
        n = sum(p.numel() for p in self._params)
        self._grad_comm_info = _qc.grad_comm_info(
            n, self._quant_info, fp16_allreduce=bool(
                strategy is not None and strategy.fp16_allreduce),
            hierarchical=mesh is not None and "dcn" in mesh.shape)
        self._q_matmul_info = _qcp.q_matmul_info(
            sum(p.numel() for p in self._params if p.dim() == 2),
            self._q_matmul)
        self._moment_bytes_info = _qcp.moment_bytes_info(
            n, getattr(optimizer, "_q_moments", None))
        if self._guard is not None:
            self._guard._sampler.set_grad_comm(self._grad_comm_info)
            self._guard._sampler.set_quant_bytes(self._q_matmul_info,
                                                 self._moment_bytes_info)
        if _bus.enabled():
            from ..observability import ledger as _ledger

            _ledger.install_backend_listener()
            _bus.emit("grad_comm", self._grad_comm_info, step=0)
            _bus.emit("q_matmul", self._q_matmul_info, step=0)
            _bus.emit("moment_bytes", self._moment_bytes_info, step=0)

    def _world_plan(self, model, return_outputs):
        """(world Group, dp Group, reduce the gradients here?) in a world
        of several ranks; None in a world of one. With the explicit dcn
        hop: checks what it needs and makes the step's
        :class:`~distributed.overlap.DcnGradHop`."""
        from ..distributed import comm
        from ..distributed.parallel import DataParallel

        if self._async_dcn:
            mesh = comm.hybrid_mesh()
            if comm.get_world_size() <= 1 or mesh is None \
                    or "dcn" not in mesh.shape or mesh.shape["dcn"] <= 1:
                raise ValueError(
                    "the explicit dcn grad reduction (async_dcn_allreduce / "
                    "hierarchical quantized_allreduce) needs a hybrid mesh "
                    "with a dcn axis (> 1) — fleet.init with "
                    "hierarchical_allreduce and a dp_degree that factors "
                    "must run first")
            if self._buffers:
                # batch statistics would be updated per dcn group
                raise NotImplementedError(
                    "the explicit dcn grad reduction does not support "
                    "models with buffers (running batch statistics) yet")
            if return_outputs:
                raise NotImplementedError(
                    "the explicit dcn grad reduction does not compose with "
                    "return_outputs")
        if comm.get_world_size() <= 1:
            return None
        world = comm._ensure_init()
        dp = comm.data_group()
        hooked = isinstance(model, DataParallel) and model.group is dp
        if self._async_dcn:
            from ..distributed.overlap import DcnGradHop

            self._hop = DcnGradHop(self._params, comm.hybrid_mesh(),
                                   self._dcn_quant)
            hooked = True
        return world, dp, dp.nranks > 1 and not hooked

    @torch.no_grad()
    def _agree(self, bits, gnorm):
        """The guard's verdict reduced over the world: the health bits'
        flags and the grad norm (already that of the full gradients), each
        the MAX over the ranks."""
        from ..distributed import collective

        b = bits.int()
        v = torch.stack([((b & f) > 0).float() for f in (
            _TG.HEALTH_LOSS, _TG.HEALTH_GRAD, _TG.HEALTH_PARAM)] + [gnorm])
        collective.all_reduce_(v, collective.ReduceOp.MAX,
                               self._world_reduce[0])
        bits = v[0] * _TG.HEALTH_LOSS + v[1] * _TG.HEALTH_GRAD \
            + v[2] * _TG.HEALTH_PARAM
        return bits == 0, bits, v[3]

    def _read_strategy(self, strategy) -> None:
        if not isinstance(strategy, DistributedStrategy):
            raise NotImplementedError(
                "TrainStep: the optimizer's strategy must be a "
                f"fleet.DistributedStrategy, got {type(strategy).__name__}")
        unported = strategy.not_ported()
        if unported:
            raise NotImplementedError(
                f"TrainStep: strategy options {unported} are not ported yet "
                "(ROADMAP queue A item 7, part 6: the elastic launcher and "
                "resharding)")
        if strategy.localsgd:
            if strategy.amp or strategy.recompute:
                raise NotImplementedError(
                    "localsgd does not compose with amp/recompute yet")
            clash = [k for k in ("quantized_allreduce",
                                 "async_dcn_allreduce", "fp16_allreduce",
                                 "sharding", "gradient_merge")
                     if getattr(strategy, k)]
            if clash:
                raise NotImplementedError(
                    f"localsgd does not compose with {clash}: LocalSGD "
                    "replaces per-step grad reduction with periodic "
                    "parameter averaging")
        self._recompute = bool(strategy.recompute)
        from ..distributed import quantized_comm as _qc
        from ..distributed import quantized_compute as _qcp

        if strategy.quantized_allreduce:
            self._quant_info = _qc.resolve_policy(
                strategy.quantized_allreduce,
                strategy.quantized_allreduce_block)
        if strategy.quantized_matmul:
            self._q_matmul = _qcp.resolve_matmul(strategy.quantized_matmul)
        if strategy.amp:
            ac = strategy.amp_configs
            dtype = "float16" if ac["use_pure_fp16"] or not ac["use_bf16"] \
                else "bfloat16"
            self._amp_ctx = dict(
                enable=True, level="O2" if ac["use_pure_fp16"] else "O1",
                dtype=dtype, custom_white_list=ac["custom_white_list"],
                custom_black_list=ac["custom_black_list"])
            if dtype == "float16" and ac["use_dynamic_loss_scaling"]:
                self._loss_scale_cfg = dict(ac)
        if strategy.async_dcn_allreduce \
                and not strategy.hierarchical_allreduce:
            raise ValueError(
                "async_dcn_allreduce requires hierarchical_allreduce: the "
                "explicit async hop is the 'dcn' level of the dcn x ici "
                "mesh factoring")
        if strategy.async_dcn_allreduce or (
                self._quant_info is not None
                and strategy.hierarchical_allreduce):
            if self._loss_scale_cfg is not None:
                raise NotImplementedError(
                    "the explicit dcn grad reduction (async_dcn_allreduce / "
                    "hierarchical quantized_allreduce) does not compose "
                    "with fp16 dynamic loss scaling yet (bf16 amp "
                    "composes)")
            self._async_dcn = True
            self._dcn_quant = self._quant_info

    def _scaler_tensors(self, scale, good, bad, applied):
        dev = self._device
        return (torch.tensor(float(scale), device=dev),
                *(torch.tensor(int(n), dtype=torch.int32, device=dev)
                  for n in (good, bad, applied)))

    def _amp_guard(self):
        if self._amp_ctx is None:
            return contextlib.nullcontext()
        return amp.auto_cast(**self._amp_ctx)

    def _q_guard(self):
        """The quantized-matmul scope of the forward and the loss."""
        if self._q_matmul is None:
            return contextlib.nullcontext()
        from ..distributed import quantized_compute as _qcp

        return _qcp.matmul_scope(self._q_matmul)

    def _hop_guard(self):
        """The backward pass's extent: the explicit dcn hop's."""
        if self._hop is None:
            return contextlib.nullcontext()
        return self._hop.backward()

    def _forward(self, ins):
        """The model's forward under the step's AMP and quantized-matmul
        scopes; with ``strategy.recompute`` through ``jit.recompute``
        (its activations recomputed in backward, the named random streams
        kept: the JAX package's ``jax.checkpoint`` of ``_fwd_segment``),
        which enters the scopes again for the recomputation."""
        model, amp_guard, q_guard = self.model, self._amp_guard, \
            self._q_guard
        if not self._recompute:
            with amp_guard(), q_guard():
                return model(*ins)
        from .recompute import recompute

        def segment(*xs):
            with amp_guard(), q_guard():
                return model(*xs)

        return recompute(segment, *ins)

    def _update_guard(self):
        """The update's extent: under the explicit quantized hop, the
        optimizer's boundary round trip stands down (quantizing twice
        would double the error)."""
        if self._dcn_quant is None \
                or not hasattr(self.opt, "_quant_explicit"):
            return contextlib.nullcontext()
        return _explicit(self.opt)

    def _tensor(self, x):
        return torch.as_tensor(to_torch(x), device=self._device)

    def _rng_state(self):
        from ..core import random as _rnd

        return _rnd.default_generator(self._device).get_state()

    def __call__(self, inputs, labels=None):
        with _prof.RecordEvent("TrainStep"):
            return self._call_impl(inputs, labels)

    def _before_write(self, news) -> None:
        """Between the update and its masked write (``LocalSGDStep``'s
        parameter average)."""

    def _call_impl(self, inputs, labels):
        ins = [self._tensor(x) for x in _as_list(inputs)]
        lbls = [self._tensor(y) for y in _as_list(labels)]
        if self._example is None:
            self._example = (ins, lbls)
        for p in self._params:
            p.grad = None
        if hasattr(self.opt, "_zero_gather"):
            self.opt._zero_gather(self._params)  # ZeRO stage 3
        inject = _FI.consume_grad_action() if self._inject_enabled else 0
        if self._guard is not None:
            self._guard.capture(ins, lbls, rng_state=self._rng_state)
        self._n_steps += 1
        _bus.set_step(self._n_steps)
        # the trace window opens before the work it covers
        _prof.step_boundary(self._n_steps)
        masked = self._guard is not None or self._loss_scale_cfg is not None
        old_bufs = [b.clone() for b in self._buffers] if masked else []
        scaling = self._loss_scale_cfg is not None
        with torch.enable_grad():
            outs = self._forward(ins)
            with self._amp_guard(), self._q_guard():
                loss = to_torch(self.loss_fn(outs, *lbls))
        with self._hop_guard():
            if scaling:
                scale = self._scaler_state[0]
                (loss * scale.to(loss.dtype)).backward()
            else:
                loss.backward()
        world = self._world_reduce
        if world is not None:
            from ..distributed import collective
            from ..distributed.parallel import reduce_gradients

            if self._hop is not None:
                self._hop.wait()  # every dcn reduction, before the clip
            elif world[2]:
                reduce_gradients(self._params, world[1])
            # the data group's mean, the same on every rank
            loss = collective.all_reduce_(
                loss.detach().clone().reshape(1), collective.ReduceOp.AVG,
                world[1]).reshape(())
        grads = [_grad_of(p) for p in self._params]
        opt = self.opt
        with torch.no_grad():
            if scaling:
                grads = [None if g is None else g / scale.to(g.dtype)
                         for g in grads]
            if inject:
                for g in grads:
                    if g is not None:
                        g.mul_(_POISON[inject])
            grads = opt._process_grads(self._params, grads)
        opt._step_count += 1
        # with loss scaling the bias correction counts applied updates
        t = (self._scaler_state[3] + 1).float() if scaling \
            else opt._step_count
        with _prof.device_annotation("TrainStep::opt_update"), \
                self._update_guard():
            news = opt._functional_update(self._params, grads, opt.get_lr(),
                                          t)
        ok = None
        if self._guard is not None:
            # the sentinel and the policy counters; ok_apply masks a
            # nonfinite step and an exploding grad norm
            with _prof.device_annotation("TrainStep::guard"), \
                    torch.no_grad():
                from ..distributed.meta_parallel import global_square_sum

                ok, bits, gnorm = _TG.grad_health(
                    loss, grads, [new_p for _, new_p, _, _ in news],
                    square_sum=global_square_sum(zip(self._params, grads)))
                if world is not None:
                    ok, bits, gnorm = self._agree(bits, gnorm)
                self._guard_state, ok = _TG.update_guard_state(
                    self._guard_state, ok, bits, gnorm, loss)
        if scaling:
            # the scaler's skip doubles as the guard's; a guard trip is a
            # bad step and backs the scale off
            if ok is None:
                ok = torch.stack([torch.isfinite(g).all() for g in grads
                                  if g is not None]).all()
                if world is not None:
                    from ..distributed import collective

                    bad = (~ok).float().reshape(1)
                    collective.all_reduce_(bad, collective.ReduceOp.MAX,
                                           world[0])
                    ok = bad[0] == 0
            self._update_scaler(ok)
        self._before_write(news)
        opt._write(news, ok)
        if old_bufs:
            with torch.no_grad():
                for b, new in zip(self._buffers,
                                  _TG.mask_step(ok, self._buffers, old_bufs)):
                    b.copy_(new)
        for p in self._params:
            p.grad = None
        if self._guard is not None:
            # the interval read; a rollback has refreshed the state
            # vector through _after_rollback
            self._guard.observe(self._guard_state)
        if self._ret_out:
            return loss.detach(), _detach(outs)
        return loss.detach()

    def _after_rollback(self) -> None:
        """The guard restored a checkpoint (parameters and optimizer, and
        through :meth:`set_state_dict` the guard's counters): reseed the
        device state vector from the restored counters."""
        if self._guard is not None:
            self._guard_state = self._guard.restored_device_state(
                self._device)

    # -- model-FLOPs utilization (observability/mfu.py) --------------------
    def flops_per_step(self):
        """FLOPs of one step's forward and backward (the matrix products;
        the optimizer update counts 0), counted once on fake tensors at the
        first call's shapes: no launch, no gradient written. None before
        the first call, or when the step cannot run on fake tensors."""
        if self._flops is None and self._example is not None:
            from ..observability import mfu as _mfu

            ins, lbls = self._example

            def loss():
                with torch.enable_grad(), self._amp_guard(), \
                        self._q_guard():
                    return to_torch(self.loss_fn(self.model(*ins), *lbls))

            self._flops = _mfu.count_flops(loss, module=self.model)
        return self._flops

    def mfu_pct(self, step_seconds: float):
        """Model-FLOPs utilization of a measured step time, percent of the
        card's peak (None on the CPU without ``PADDLE_OBS_PEAK_FLOPS``).
        The peak is asked first: without it the count is not paid for."""
        from ..observability import mfu as _mfu

        if _mfu.peak_flops() is None:
            return None
        return _mfu.mfu_pct(self.flops_per_step(), step_seconds)

    @torch.no_grad()
    def _update_scaler(self, finite: torch.Tensor) -> None:
        """update_loss_scaling on the device: count good and bad steps,
        grow the scale after ``incr_every_n_steps`` good ones, back it off
        (not below 1) after ``decr_every_n_nan_or_inf`` bad ones."""
        cfg = self._loss_scale_cfg
        scale, good, bad, applied = self._scaler_state
        zero = torch.zeros_like(good)
        applied = torch.where(finite, applied + 1, applied)
        good = torch.where(finite, good + 1, zero)
        bad = torch.where(finite, zero, bad + 1)
        do_incr = finite & (good >= cfg["incr_every_n_steps"])
        do_decr = ~finite & (bad >= cfg["decr_every_n_nan_or_inf"])
        scale = torch.where(do_incr, scale * cfg["incr_ratio"], scale)
        scale = torch.where(do_decr, (scale * cfg["decr_ratio"]).clamp(
            min=1.0), scale)
        self._scaler_state = (scale, torch.where(do_incr, zero, good),
                              torch.where(do_decr, zero, bad), applied)

    # -- persisted step state ------------------------------------------------
    def state_dict(self) -> dict:
        """The dynamic loss scaler's state (scale, good and bad step
        counts, applied updates), read to the host, and the guard's
        counters: the step state an ``auto_checkpoint`` generation carries
        when the step is registered as an extra
        (``register(scaler=step)``)."""
        out = {}
        if self._loss_scale_cfg is not None:
            scale, good, bad, applied = self._scaler_state
            out["scaler"] = {"scale": float(scale), "good_steps": int(good),
                             "bad_steps": int(bad),
                             "applied_steps": int(applied)}
        if self._guard is not None:
            out["guard"] = self._guard.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        state = dict(state or {})
        sc = state.get("scaler")
        if self._loss_scale_cfg is not None and sc:
            self._scaler_state = self._scaler_tensors(
                sc["scale"], sc["good_steps"], sc["bad_steps"],
                sc["applied_steps"])
        if self._guard is not None and state.get("guard"):
            self._guard.set_state_dict(state["guard"])
            self._after_rollback()


def _detach(outs):
    outs = to_torch(outs)
    if isinstance(outs, torch.Tensor):
        return outs.detach()
    if isinstance(outs, (list, tuple)):
        return type(outs)(_detach(o) for o in outs)
    return outs
