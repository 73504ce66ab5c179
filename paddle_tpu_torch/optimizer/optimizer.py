"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The ``Optimizer`` base, ``SGD``, ``Momentum`` and ``Adam`` / ``AdamW``.
Each update rule is the JAX package's pure rule (``_sgd_rule``,
``_momentum_rule``, ``_adam_rule``, ``_adamw_rule``) written in plain
PyTorch on the parameter's device; JAX runs it outside any Pallas kernel
too. State lives in per-parameter accumulators named as in JAX
(``velocity``; ``moment1``, ``moment2``), created on first use. Updates
happen in place, under ``torch.no_grad``, on the parameter and
accumulator buffers, where JAX returns new arrays.

Two entry points apply an update: ``step()`` from the accumulated
``.grad`` (the eager path), and ``_functional_update`` then ``_write``
(what ``jit.TrainStep`` calls), whose write can be masked on a device
flag so that a skipped step leaves parameters and moments unchanged.
Both first add the regularizer terms to the gradients and then clip them
(``_process_grads``), as the JAX package does.

The learning rate is a float or an ``optimizer.lr.LRScheduler``, read
through ``get_lr``. ``weight_decay`` is a regularizer
(``regularizer.L1Decay`` / ``L2Decay``) or a float, which means
``L2Decay`` of it; a parameter's own ``regularizer`` attribute takes
precedence. ``AdamW`` decays decoupled instead.

Not ported yet, and refused when asked for: ``lr_ratio``,
``multi_precision`` and ``lazy_mode``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..regularizer import L2Decay, WeightDecayRegularizer
from ..utils.train_guard import mask_step
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


def _not_ported(what: str) -> None:
    raise NotImplementedError(f"optimizer: {what} is not ported yet")


class Optimizer:
    """Base: learning rate, the parameter list, regularizer, gradient
    clip, accumulators and the step count ``t`` of the bias correction
    (one per ``step()`` or ``TrainStep`` call, as in JAX; a 0-dim tensor
    when ``TrainStep`` counts applied updates on the device)."""

    #: accumulator names of the rule, in JAX's spelling
    _acc_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError("optimizer: learning_rate must be a float or an "
                            "LRScheduler")
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._grad_clip = grad_clip
        if isinstance(weight_decay, WeightDecayRegularizer):
            self._regularization = weight_decay
        elif isinstance(weight_decay, (int, float)) \
                and not isinstance(weight_decay, bool):
            self._regularization = L2Decay(weight_decay)
        else:
            self._regularization = None
        self._parameter_list: Optional[List[torch.nn.Parameter]] = None
        self._names: Dict[int, str] = {}
        if parameters is not None:
            self._set_parameters(parameters)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0

    def _set_parameters(self, parameters) -> None:
        """Parameters, or ``(name, parameter)`` pairs as
        ``model.named_parameters()`` yields them (the names are what
        ``apply_decay_param_fun`` sees)."""
        params = []
        for item in parameters:
            if isinstance(item, tuple):
                name, item = item
                self._names[id(item)] = name
            params.append(item)
        self._parameter_list = params

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- state --------------------------------------------------------------
    def _get_params(self) -> List[torch.nn.Parameter]:
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters; "
                             "pass parameters=")
        return self._parameter_list

    def _acc(self, name: str, p: torch.Tensor) -> torch.Tensor:
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(p)
        return store[id(p)]

    # -- the update ----------------------------------------------------------
    def _process_grads(self, params, grads):
        """Regularizer terms (the parameter's own ``regularizer`` first,
        else the optimizer's), then the gradient clip. A ``None`` gradient
        stays ``None``."""
        out = []
        for p, g in zip(params, grads):
            r = getattr(p, "regularizer", None) or self._regularization
            out.append(g if g is None or r is None
                       else g + r.grad_term(p.detach()))
        grads = out
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        return grads

    def _rule(self, p, g, accs, lr, t):
        """One parameter's update: (new_p, {acc_name: new_acc}), out of
        place."""
        raise NotImplementedError

    @torch.no_grad()
    def _functional_update(self, params, grads, lr: float, t: int):
        """The rule applied to every parameter with a gradient (a ``None``
        gradient leaves its parameter and state untouched), out of place:
        a list of ``(param, new_param, accs, new_accs)`` for
        :meth:`_write`. Nothing is written yet, so a caller can judge the
        new parameters first."""
        news = []
        for p, g in zip(params, grads):
            if g is None:
                continue
            accs = {n: self._acc(n, p) for n in self._acc_names}
            new_p, new_accs = self._rule(p, g.to(p.dtype), accs, lr, t)
            news.append((p, new_p, accs, new_accs))
        return news

    @staticmethod
    @torch.no_grad()
    def _write(news, ok: Optional[torch.Tensor] = None) -> None:
        """Write the updates of ``_functional_update`` into the parameter
        and accumulator buffers. With ``ok`` (a 0-dim bool tensor on the
        device) each value written is ``where(ok, new, old)``: a step whose
        ``ok`` is False leaves them bitwise unchanged, and the host never
        reads ``ok``."""
        for p, new_p, accs, new_accs in news:
            olds = [p] + [accs[n] for n in accs]
            fresh = [new_p] + [new_accs[n] for n in accs]
            if ok is not None:
                fresh = mask_step(ok, fresh, olds)
            for o, f in zip(olds, fresh):
                o.copy_(f)

    def step(self) -> None:
        """Apply one update from the accumulated ``.grad`` (eager path)."""
        params = [p for p in self._get_params() if p.grad is not None]
        if not params:
            return
        self._step_count += 1
        with torch.no_grad():
            grads = self._process_grads(params, [p.grad for p in params])
        self._write(self._functional_update(params, grads, self.get_lr(),
                                            self._step_count))

    def clear_grad(self) -> None:
        for p in self._get_params():
            p.grad = None


class SGD(Optimizer):
    """``_sgd_rule``: ``p - lr * g``."""

    def _rule(self, p, g, accs, lr, t):
        return p - lr * g, {}


class Momentum(Optimizer):
    """``_momentum_rule``: ``v = momentum * v + g``, then ``p - lr * v``,
    or with ``use_nesterov`` ``p - lr * (g + momentum * v)``."""

    _acc_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _rule(self, p, g, accs, lr, t):
        v = self._momentum * accs["velocity"] + g
        step = g + self._momentum * v if self._nesterov else v
        return p - lr * step, {"velocity": v}


class Adam(Optimizer):
    """``_adam_rule``: bias-corrected first and second moments."""

    _acc_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            _not_ported("lazy_mode")
        if multi_precision:
            _not_ported("multi_precision")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _moments(self, g, accs, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * accs["moment1"] + (1 - b1) * g
        v = b2 * accs["moment2"] + (1 - b2) * (g * g)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return m, v, mhat / (torch.sqrt(vhat) + self._epsilon)

    def _rule(self, p, g, accs, lr, t):
        m, v, upd = self._moments(g, accs, t)
        return p - lr * upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay (``_adamw_rule``):
    ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
    ``apply_decay_param_fun(name)`` decides per parameter whether it
    decays; the name is the one ``model.named_parameters()`` gives (pass
    those pairs as ``parameters``; ``jit.TrainStep`` does when it supplies
    the model's parameters)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            _not_ported("lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _rule(self, p, g, accs, lr, t):
        wd = self._wd
        if self._apply_decay_param_fun is not None:
            if id(p) not in self._names:
                raise ValueError(
                    "AdamW: apply_decay_param_fun needs parameter names; "
                    "pass model.named_parameters() as parameters")
            if not self._apply_decay_param_fun(self._names[id(p)]):
                wd = 0.0
        m, v, upd = self._moments(g, accs, t)
        return p - lr * (upd + wd * p), {"moment1": m, "moment2": v}
