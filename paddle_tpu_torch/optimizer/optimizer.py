"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The ``Optimizer`` base, ``SGD``, ``Momentum``, ``Adam`` / ``AdamW``,
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb`` and ``Lars``
(``LarsMomentum``). Each update rule is the JAX package's pure rule
(``_sgd_rule`` ... ``_lamb_rule``) written in plain PyTorch on the
parameter's device; JAX runs it outside any Pallas kernel too. State lives
in per-parameter accumulators named as in JAX (``velocity``; ``moment1``,
``moment2``; ``moment``, ``inf_norm``; ``avg_squared_grad``, ...), created
on first use. Updates happen in place, under ``torch.no_grad``, on the
parameter and accumulator buffers, where JAX returns new arrays. The
trust ratios of ``Lamb`` and ``Lars`` are ``torch.where`` branches on the
device, as JAX's ``jnp.where``: a parameter or update of norm 0 (a bias at
its first step) takes ratio 1 (``Lars``: the plain rate).

Two entry points apply an update: ``step()`` (or ``minimize(loss)``)
from the accumulated ``.grad`` (the eager path), and
``_functional_update`` then ``_write`` (what ``jit.TrainStep`` calls),
whose write can be masked on a device flag so that a skipped step leaves
parameters and every accumulator unchanged. Both first add the regularizer
terms to the gradients and then clip them (``_process_grads``), as the JAX
package does, and both scale the learning rate by the parameter's
``ParamAttr(learning_rate=)`` (``optimize_attr["learning_rate"]``).

The learning rate is a float or an ``optimizer.lr.LRScheduler``, read
through ``get_lr``. ``weight_decay`` is a regularizer
(``regularizer.L1Decay`` / ``L2Decay``) or a float, which means
``L2Decay`` of it; a parameter's own ``regularizer`` attribute takes
precedence. ``AdamW`` decays decoupled instead, ``Lamb`` and ``Lars``
inside their rules.

``state_dict()`` / ``set_state_dict()`` use the JAX package's keys:
``"<name>.<accumulator>"`` with the parameter's ``name``, or
``param_<i>`` (its index in the parameter list) when it has none,
``"@step"`` and ``"LR_Scheduler"``; the values load as numpy arrays
either way.

Named departures, where the JAX package takes an argument and drops it:
``AdamW(lr_ratio=)`` scales each parameter's rate by ``lr_ratio(param)``,
as upstream Paddle does; ``multi_precision=True`` keeps a float32
``master_weight`` accumulator for each 16-bit parameter, runs the rule on
it and writes the parameter rounded from it (float32 parameters: no
change). ``lazy_mode`` is taken and changes nothing: gradients are dense in
both packages, and for a dense gradient the lazy update is the full one.
``Lars``' ``exclude_from_weight_decay`` and ``AdamW``'s
``apply_decay_param_fun`` read the parameter's ``name`` and, where it has
none, its ``named_parameters()`` name (the JAX package reads ``name``
alone).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..regularizer import L2Decay, WeightDecayRegularizer
from ..utils.train_guard import mask_step
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "LarsMomentum"]

_LOW = (torch.float16, torch.bfloat16)


class Optimizer:
    """Base: learning rate, the parameter list, regularizer, gradient
    clip, accumulators and the step count ``t`` of the bias correction
    (one per ``step()`` or ``TrainStep`` call, as in JAX; a 0-dim tensor
    when ``TrainStep`` counts applied updates on the device)."""

    #: accumulator names of the rule, in JAX's spelling
    _acc_names: tuple = ()
    #: keep float32 master weights of 16-bit parameters (Adam, AdamW)
    _multi_precision = False

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

    def _param_name(self, p) -> str:
        """The parameter's ``name``, else its ``named_parameters()`` name,
        else ""."""
        return getattr(p, "name", None) or self._names.get(id(p), "")

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def _param_lr(self, p, lr):
        """``lr`` times the parameter's ``ParamAttr(learning_rate=)``."""
        mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
        return lr if mult == 1.0 else lr * mult

    # -- state --------------------------------------------------------------
    def _get_params(self) -> List[torch.nn.Parameter]:
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters; "
                             "pass parameters=")
        return self._parameter_list

    def _acc_init(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """Zeros; a master weight starts as the parameter's value in
        float32."""
        if name == "master_weight":
            return like.detach().to(torch.float32, copy=True)
        return torch.zeros_like(like)

    def _acc(self, name: str, p: torch.Tensor, like=None) -> torch.Tensor:
        """The accumulator ``name`` of ``p``, made on first use like
        ``like`` (``p`` itself by default)."""
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = self._acc_init(name, p if like is None else like)
        return store[id(p)]

    def _state_names(self):
        """``id(param) -> key prefix`` of the JAX package's state keys."""
        return {id(p): getattr(p, "name", None) or f"param_{i}"
                for i, p in enumerate(self._get_params())}

    def state_dict(self) -> Dict:
        """The accumulators as ``Tensor`` under ``"<name>.<acc>"``, the
        step count under ``"@step"`` and the scheduler's state under
        ``"LR_Scheduler"``: the JAX package's keys."""
        from ..core.tensor import Tensor

        name_of = self._state_names()
        out = {}
        for acc_name, store in self._accumulators.items():
            for pid, t in store.items():
                if pid in name_of:
                    out[f"{name_of[pid]}.{acc_name}"] = Tensor._wrap(
                        t.detach().clone())
        out["@step"] = int(self._step_count)
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state) -> None:
        """Load a ``state_dict`` of either package (values as ``Tensor``,
        torch tensors or numpy arrays), each accumulator on its
        parameter's device."""
        from ..core.tensor import to_torch

        by_name = {n: p for p, n in zip(self._get_params(),
                                        self._state_names().values())}
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for key, val in state.items():
            if key in ("@step", "LR_Scheduler"):
                continue
            pname, acc_name = key.rsplit(".", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            v = to_torch(val)
            v = v.detach() if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.array(val))
            dtype = torch.float32 if acc_name == "master_weight" \
                or self._multi_precision and p.dtype in _LOW else p.dtype
            self._accumulators.setdefault(acc_name, {})[id(p)] = v.to(
                device=p.device, dtype=dtype).clone()

    set_dict = set_state_dict

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

    def _rule(self, param, p, g, accs, lr, t):
        """One parameter's update: (new_p, {acc_name: new_acc}), out of
        place. ``p`` is the value to update (``param`` itself, or its
        float32 master weight under ``multi_precision``); ``param`` is
        read for its name only."""
        raise NotImplementedError

    @torch.no_grad()
    def _functional_update(self, params, grads, lr: float, t: int):
        """The rule applied to every parameter with a gradient (a ``None``
        gradient leaves its parameter and state untouched), out of place,
        at each parameter's rate: a list of ``(param, new_param, accs,
        new_accs)`` for :meth:`_write`. Nothing is written yet, so a
        caller can judge the new parameters first."""
        news = []
        for p, g in zip(params, grads):
            if g is None:
                continue
            p_lr = self._param_lr(p, lr)
            if self._multi_precision and p.dtype in _LOW:
                master = self._acc("master_weight", p)
                accs = {n: self._acc(n, p, like=master)
                        for n in self._acc_names}
                new_m, new_accs = self._rule(p, master, g.float(), accs,
                                             p_lr, t)
                accs["master_weight"] = master
                new_accs["master_weight"] = new_m
                news.append((p, new_m.to(p.dtype), accs, new_accs))
                continue
            accs = {n: self._acc(n, p) for n in self._acc_names}
            new_p, new_accs = self._rule(p, p, g.to(p.dtype), accs, p_lr, t)
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

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` (unless it already ran on this loss, the
        1.x idiom ``loss.backward(); opt.minimize(loss)``), then
        ``step()``. Returns ``(None, None)``. In static mode a symbolic
        loss RECORDS the backward and update into the default program
        instead (the append_backward analog, fluid/backward.py:1337):
        ``static.Executor.run`` applies them, through this ``step()``."""
        if parameters is not None:
            self._set_parameters(parameters)
        from ..static.program import default_main_program, static_var

        loss_var = static_var(loss)
        if loss_var is not None:
            prog = default_main_program()
            if self._parameter_list is None:
                self._parameter_list = [
                    p for p in prog.all_parameters() if p.requires_grad]
            prog.optimize_directives.append((self, loss_var))
            prog._version += 1
            return None, None
        if not getattr(loss, "_backward_ran", False):
            loss.backward()
        self.step()
        return None, None


class SGD(Optimizer):
    """``_sgd_rule``: ``p - lr * g``."""

    def _rule(self, param, p, g, accs, lr, t):
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

    def _rule(self, param, p, g, accs, lr, t):
        v = self._momentum * accs["velocity"] + g
        step = g + self._momentum * v if self._nesterov else v
        return p - lr * step, {"velocity": v}


class Adam(Optimizer):
    """``_adam_rule``: bias-corrected first and second moments.
    ``multi_precision`` and ``lazy_mode``: the module's notes."""

    _acc_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._multi_precision = bool(multi_precision)

    def _moments(self, g, accs, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * accs["moment1"] + (1 - b1) * g
        v = b2 * accs["moment2"] + (1 - b2) * (g * g)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return m, v, mhat / (torch.sqrt(vhat) + self._epsilon)

    def _rule(self, param, p, g, accs, lr, t):
        m, v, upd = self._moments(g, accs, t)
        return p - lr * upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay (``_adamw_rule``):
    ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
    ``apply_decay_param_fun(name)`` decides per parameter whether it
    decays, on its name (the module's notes); ``lr_ratio(param)`` scales
    its rate (a named departure: the module's notes)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _param_lr(self, p, lr):
        lr = super()._param_lr(p, lr)
        return lr if self._lr_ratio is None else lr * self._lr_ratio(p)

    def _rule(self, param, p, g, accs, lr, t):
        wd = self._wd
        if self._apply_decay_param_fun is not None:
            name = self._param_name(param)
            if not name:
                raise ValueError(
                    "AdamW: apply_decay_param_fun needs parameter names; "
                    "pass model.named_parameters() as parameters")
            if not self._apply_decay_param_fun(name):
                wd = 0.0
        m, v, upd = self._moments(g, accs, t)
        return p - lr * (upd + wd * p), {"moment1": m, "moment2": v}


class Adamax(Optimizer):
    """``_adamax_rule``: ``m = b1 m + (1 - b1) g``, ``u = max(b2 u,
    |g|)``, ``p - lr / (1 - b1^t) * m / (u + eps)``."""

    _acc_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _rule(self, param, p, g, accs, lr, t):
        b1 = self._beta1
        m = b1 * accs["moment"] + (1 - b1) * g
        u = torch.maximum(self._beta2 * accs["inf_norm"], g.abs())
        return (p - lr / (1 - b1 ** t) * m / (u + self._epsilon),
                {"moment": m, "inf_norm": u})


class Adagrad(Optimizer):
    """``_adagrad_rule``: ``G = G + g^2``, ``p - lr g / (sqrt(G) + eps)``,
    ``G`` starting at ``initial_accumulator_value``."""

    _acc_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _acc_init(self, name, like):
        if name == "moment":
            return torch.full_like(like, self._init_acc)
        return super()._acc_init(name, like)

    def _rule(self, param, p, g, accs, lr, t):
        G = accs["moment"] + g * g
        return p - lr * g / (torch.sqrt(G) + self._epsilon), {"moment": G}


class Adadelta(Optimizer):
    """``_adadelta_rule`` (the rate is not read, as in the JAX package):
    ``Eg = rho Eg + (1 - rho) g^2``, ``dx = -sqrt(Ex + eps) / sqrt(Eg +
    eps) g``, ``Ex = rho Ex + (1 - rho) dx^2``, ``p + dx``."""

    _acc_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _rule(self, param, p, g, accs, lr, t):
        rho, eps = self._rho, self._epsilon
        Eg = rho * accs["avg_squared_grad"] + (1 - rho) * g * g
        dx = -torch.sqrt(accs["avg_squared_update"] + eps) \
            / torch.sqrt(Eg + eps) * g
        Ex = rho * accs["avg_squared_update"] + (1 - rho) * dx * dx
        return p + dx, {"avg_squared_grad": Eg, "avg_squared_update": Ex}


class RMSProp(Optimizer):
    """``_rmsprop_rule``: ``ms = rho ms + (1 - rho) g^2``; centered, also
    ``mg = rho mg + (1 - rho) g`` and the denominator ``ms - mg^2``;
    ``mom = momentum mom + lr g / sqrt(denom + eps)``, ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)
        self._acc_names = ("mean_square", "momentum") + (
            ("mean_grad",) if centered else ())

    def _rule(self, param, p, g, accs, lr, t):
        rho = self._rho
        ms = rho * accs["mean_square"] + (1 - rho) * g * g
        new = {"mean_square": ms}
        denom = ms
        if self._centered:
            mg = new["mean_grad"] = rho * accs["mean_grad"] + (1 - rho) * g
            denom = ms - mg * mg
        mom = new["momentum"] = self._momentum * accs["momentum"] \
            + lr * g / torch.sqrt(denom + self._epsilon)
        return p - mom, new


def _norm(t):
    return torch.sqrt(torch.sum(t * t))


class Lamb(Optimizer):
    """``_lamb_rule``: Adam's bias-corrected step plus ``lamb_weight_decay
    * p``, scaled by the trust ratio ``|p| / |r|`` (1 where either norm is
    0); ``exclude_from_weight_decay_fn(param)`` True turns the decay off
    for that parameter."""

    _acc_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _rule(self, param, p, g, accs, lr, t):
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        b1, b2 = self._beta1, self._beta2
        m = b1 * accs["moment1"] + (1 - b1) * g
        v = b2 * accs["moment2"] + (1 - b2) * (g * g)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + wd * p
        p_norm, r_norm = _norm(p), _norm(r)
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        return p - lr * trust * r, {"moment1": m, "moment2": v}


class Lars(Optimizer):
    """``_lars_rule`` (LARS momentum): the local rate ``lr * lars_coeff *
    |p| / (|g| + wd |p| + eps)`` (``lr`` where either norm is 0), ``v =
    momentum v + local_lr (g + wd p)``, ``p - v``; ``wd`` is 0 for a
    parameter whose name contains a tag of
    ``exclude_from_weight_decay``, and ``eps`` is ``epsilon or 1e-9``."""

    _acc_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, parameters=None,
                 grad_clip=None, exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = float(momentum)
        self._coeff = float(lars_coeff)
        self._wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])

    def _rule(self, param, p, g, accs, lr, t):
        name = self._param_name(param)
        wd = 0.0 if any(tag in name for tag in self._exclude) else self._wd
        p_norm, g_norm = _norm(p), _norm(g)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._coeff * p_norm
            / (g_norm + wd * p_norm + (self._epsilon or 1e-9)),
            torch.full_like(p_norm, lr))
        v = self._momentum * accs["velocity"] + local_lr * (g + wd * p)
        return p - v, {"velocity": v}


LarsMomentum = Lars
