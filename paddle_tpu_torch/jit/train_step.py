"""The training step: forward, loss, backward and the optimizer update in
one call (counterpart of ``paddle_tpu/jit/train_step.py``).

JAX compiles ``_step_fn`` into one XLA program; here the step runs
eagerly: the model's forward and ``loss_fn`` under autograd, one
``backward()`` (through the kernels' autograd Functions, so the B3/B4/B7
backward kernels run), then the update of ``optimizer._functional_update``
with the guard's mask. Parameters without a gradient (off the loss's
graph) keep their values and state, as in JAX's ``_used_mask``.

The guard (``utils/train_guard.py``) runs unless ``PADDLE_GUARD_MODE=off``:
a step whose loss, gradients (or, with ``PADDLE_GUARD_CHECK_PARAMS=1``,
new parameters) are not finite leaves parameters and moments bitwise
unchanged, decided on the device with no host read. As in JAX the step
count ``t`` of the bias correction advances on every call.

Not ported yet, and refused: the distributed strategy's options
(``optimizer.user_defined_strategy``: amp, recompute, localsgd,
quantized or dcn gradient exchange), ``grad_post_hook``, and the guard's
host half.
"""
from __future__ import annotations

from typing import Callable

import torch

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
        if getattr(optimizer, "user_defined_strategy", None) is not None:
            raise NotImplementedError(
                "TrainStep: the distributed strategy's options (amp, "
                "recompute, localsgd, quantized or dcn gradient exchange) "
                "are not ported yet")
        self.model = model
        self.loss_fn = loss_fn
        self.opt = optimizer
        self._ret_out = return_outputs
        if optimizer._parameter_list is None:
            optimizer._set_parameters(model.named_parameters())
        self._params = [p for p in optimizer._get_params()
                        if p.requires_grad]
        self._guard = _TG.guard_mode() != "off"
        self._device = self._params[0].device if self._params \
            else torch.device("cpu")

    def _tensor(self, x):
        return torch.as_tensor(x, device=self._device)

    def __call__(self, inputs, labels=None):
        ins = [self._tensor(x) for x in _as_list(inputs)]
        lbls = [self._tensor(y) for y in _as_list(labels)]
        for p in self._params:
            p.grad = None
        with torch.enable_grad():
            outs = self.model(*ins)
            loss = self.loss_fn(outs, *lbls)
        loss.backward()
        grads = [p.grad for p in self._params]
        opt = self.opt
        opt._step_count += 1
        news = opt._functional_update(self._params, grads, opt.get_lr(),
                                      opt._step_count)
        ok = None
        if self._guard:
            ok, _, _ = _TG.grad_health(loss, grads,
                                       [new_p for _, new_p, _, _ in news])
        opt._write(news, ok)
        for p in self._params:
            p.grad = None
        if self._ret_out:
            return loss.detach(), _detach(outs)
        return loss.detach()


def _detach(outs):
    if isinstance(outs, torch.Tensor):
        return outs.detach()
    if isinstance(outs, (list, tuple)):
        return type(outs)(_detach(o) for o in outs)
    return outs
