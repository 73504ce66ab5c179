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
The bias correction then counts applied updates only. Every other
strategy option raises ``NotImplementedError``.

The guard (``utils/train_guard.py``) runs unless ``PADDLE_GUARD_MODE=off``:
a step whose loss, gradients (or, with ``PADDLE_GUARD_CHECK_PARAMS=1``,
new parameters) are not finite leaves parameters and moments bitwise
unchanged, decided on the device with no host read. As in JAX the step
count ``t`` of the bias correction advances on every call.

Buffers that the forward updates (batch norm's running statistics) are
masked with the same verdict: a skipped step leaves them bitwise
unchanged too, as the JAX package masks its ``new_b``. (With the guard
off, the JAX package masks them on neither skip; the port masks them on
the fp16 scaler's skip as well, so a non-finite batch never reaches the
running statistics.)

Not ported yet, and refused: ``grad_post_hook`` and the guard's host half.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from .. import amp
from ..distributed.fleet.strategy import DistributedStrategy
from ..utils import train_guard as _TG

__all__ = ["TrainStep"]


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

    ``loss_fn(model_outputs, *labels)`` returns a scalar loss tensor. Each
    call returns the loss, detached (and the detached outputs with
    ``return_outputs=True``); parameters' ``.grad`` is cleared after the
    update."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, *, return_outputs: bool = False):
        self._amp_ctx = None          # amp.auto_cast kwargs of the step
        self._loss_scale_cfg = None   # float16 dynamic loss scaling
        self._scaler_state = ()       # (scale, good, bad, applied) tensors
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
        self._guard = _TG.guard_mode() != "off"
        self._device = self._params[0].device if self._params \
            else torch.device("cpu")
        if self._loss_scale_cfg is not None:
            self._scaler_state = self._scaler_tensors(
                self._loss_scale_cfg["init_loss_scaling"], 0, 0, 0)

    def _read_strategy(self, strategy) -> None:
        if not isinstance(strategy, DistributedStrategy):
            raise NotImplementedError(
                "TrainStep: the optimizer's strategy must be a "
                f"fleet.DistributedStrategy, got {type(strategy).__name__}")
        unported = strategy.not_ported()
        if unported:
            raise NotImplementedError(
                f"TrainStep: strategy options {unported} are not ported yet "
                "(the port applies amp)")
        if not strategy.amp:
            return
        ac = strategy.amp_configs
        dtype = "float16" if ac["use_pure_fp16"] or not ac["use_bf16"] \
            else "bfloat16"
        self._amp_ctx = dict(
            enable=True, level="O2" if ac["use_pure_fp16"] else "O1",
            dtype=dtype, custom_white_list=ac["custom_white_list"],
            custom_black_list=ac["custom_black_list"])
        if dtype == "float16" and ac["use_dynamic_loss_scaling"]:
            self._loss_scale_cfg = dict(ac)

    def _scaler_tensors(self, scale, good, bad, applied):
        dev = self._device
        return (torch.tensor(float(scale), device=dev),
                *(torch.tensor(int(n), dtype=torch.int32, device=dev)
                  for n in (good, bad, applied)))

    def _amp_guard(self):
        if self._amp_ctx is None:
            return contextlib.nullcontext()
        return amp.auto_cast(**self._amp_ctx)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self._device)

    def __call__(self, inputs, labels=None):
        ins = [self._tensor(x) for x in _as_list(inputs)]
        lbls = [self._tensor(y) for y in _as_list(labels)]
        for p in self._params:
            p.grad = None
        masked = self._guard or self._loss_scale_cfg is not None
        old_bufs = [b.clone() for b in self._buffers] if masked else []
        with torch.enable_grad(), self._amp_guard():
            outs = self.model(*ins)
            loss = self.loss_fn(outs, *lbls)
        scaling = self._loss_scale_cfg is not None
        if scaling:
            scale = self._scaler_state[0]
            (loss * scale.to(loss.dtype)).backward()
        else:
            loss.backward()
        grads = [p.grad for p in self._params]
        opt = self.opt
        with torch.no_grad():
            if scaling:
                grads = [None if g is None else g / scale.to(g.dtype)
                         for g in grads]
            grads = opt._process_grads(self._params, grads)
        opt._step_count += 1
        # with loss scaling the bias correction counts applied updates
        t = (self._scaler_state[3] + 1).float() if scaling \
            else opt._step_count
        news = opt._functional_update(self._params, grads, opt.get_lr(), t)
        ok = None
        if self._guard:
            ok, _, _ = _TG.grad_health(loss, grads,
                                       [new_p for _, new_p, _, _ in news])
        if scaling:
            # the scaler's skip doubles as the guard's; a guard trip is a
            # bad step and backs the scale off
            if ok is None:
                ok = torch.stack([torch.isfinite(g).all() for g in grads
                                  if g is not None]).all()
            self._update_scaler(ok)
        opt._write(news, ok)
        if old_bufs:
            with torch.no_grad():
                for b, new in zip(self._buffers,
                                  _TG.mask_step(ok, self._buffers, old_bufs)):
                    b.copy_(new)
        for p in self._params:
            p.grad = None
        if self._ret_out:
            return loss.detach(), _detach(outs)
        return loss.detach()

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
        counts, applied updates), read to the host."""
        if self._loss_scale_cfg is None:
            return {}
        scale, good, bad, applied = self._scaler_state
        return {"scaler": {"scale": float(scale), "good_steps": int(good),
                           "bad_steps": int(bad),
                           "applied_steps": int(applied)}}

    def set_state_dict(self, state) -> None:
        sc = dict(state or {}).get("scaler")
        if self._loss_scale_cfg is not None and sc:
            self._scaler_state = self._scaler_tensors(
                sc["scale"], sc["good_steps"], sc["bad_steps"],
                sc["applied_steps"])


def _detach(outs):
    if isinstance(outs, torch.Tensor):
        return outs.detach()
    if isinstance(outs, (list, tuple)):
        return type(outs)(_detach(o) for o in outs)
    return outs
