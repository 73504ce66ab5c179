"""Static-graph ``Executor`` (counterpart of
``paddle_tpu/static/executor.py``).

Reference: python/paddle/fluid/executor.py ``Executor.run`` (:916) ->
``_run_impl`` (:1112) -> ``_run_program`` (:1253) feed/fetch + program
cache, over the C++ op-loop interpreter (framework/executor.cc:166,414).

``run`` replays the recorded ops eagerly on the executor's device: feeds
(numpy arrays, in the placeholders' types) fill the placeholders, each op
runs its torch function on the resolved inputs, live tensors resolve to
their current values. With an ``opt.minimize(loss)`` directive the replay
runs with gradients on; then one ``backward()`` from the replayed loss and
the optimizer's ``step()`` (its gradient processing, clip and
regularizers, then its rule): the update the eager ``minimize`` applies.
Persistable-state writes land in the live objects after the run, and each
``rng_feed`` placeholder gets a fresh seed from the package's generator.
The plan of a run (its leaves, parameters and seed feeds) is cached per
(program version, feed signature, fetch set). Where the JAX package
compiles the replay into one XLA program, the port's program launches
the kernels of the eager step of the same model.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.device import Place, resolve_device
from ..core.random import default_generator
from ..core.tensor import Tensor, _host
from .program import Program, Variable, default_main_program

__all__ = ["CompiledProgram", "Executor", "global_scope"]


class CompiledProgram:
    """fluid/compiler.py:88 CompiledProgram.with_data_parallel analog. The
    port runs one device: data parallelism over several raises (as the
    mesh of ``distributed/comm.py`` does), and over one it is the program
    itself."""

    def __init__(self, program, build_strategy=None):
        self.program = program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        from ..distributed import comm

        n = len(places) if isinstance(places, (list, tuple)) else 1
        if n > 1 or comm.get_world_size() > 1:
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel over {n} places: the "
                "port runs one device so far; several cards are a later "
                "slice")
        return self


class _Scope:
    def find_var(self, name):
        return None


_scope = _Scope()


def global_scope():
    return _scope


def _leaf(inp):
    """A non-Variable op input at run time: a ``Tensor``'s current value,
    a torch tensor or constant as it is."""
    return inp._data if isinstance(inp, Tensor) else inp


def replay(ops, env: Dict[int, torch.Tensor]) -> None:
    """Run ``ops`` in order, reading and writing Variable values in
    ``env`` (by ``Variable.id``)."""
    for op in ops:
        vals = []
        for i in op.inputs:
            if isinstance(i, Variable):
                if i.id not in env:
                    raise KeyError(f"variable '{i.name}' has no producer op "
                                   "and is not fed")
                vals.append(env[i.id])
            else:
                vals.append(_leaf(i))
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and op.grad_enabled):
            out = op.fn(*vals)
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for var, o in zip(op.out_vars, outs):
            env[var.id] = o


class Executor:
    """executor.py:916 parity surface (run/close). ``place`` is the device
    of the run (a Place, a device string, or None for the package's
    device: the card unless the caller asked for the CPU)."""

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict = {}

    def close(self):
        self._cache.clear()

    def _device(self) -> torch.device:
        if isinstance(self.place, (Place, torch.device, str)):
            return resolve_device(self.place)
        return resolve_device(None)

    def _build(self, program: Program, fetch_vars):
        leaves = set()
        rng_vars = []
        for op in program.ops:
            for t in (*op.inputs, *op.touched):
                if isinstance(t, Variable):
                    if t.is_rng and t not in rng_vars:
                        rng_vars.append(t)
                elif isinstance(t, (Tensor, torch.Tensor)):
                    leaves.add(id(t))
        for v in fetch_vars:
            if not isinstance(v, Variable) and id(v) not in leaves:
                raise ValueError(
                    "fetch_list contains a concrete Tensor that never "
                    "appears in the program; fetch program variables or "
                    "tensors the ops consume"
                )
        directives = program.optimize_directives
        if len(directives) > 1:
            raise NotImplementedError(
                "multiple minimize() calls in one Program"
            )
        opt, loss_var = directives[0] if directives else (None, None)
        params = [p for p in program.all_parameters() if p.requires_grad]
        return params, opt, loss_var, rng_vars

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy=True):
        """executor.py:916. Returns the fetched values in fetch_list order
        (numpy arrays, or ``Tensor`` with ``return_numpy=False``)."""
        if isinstance(program, CompiledProgram):
            program = program.program
        program = program if program is not None else default_main_program()
        feed = dict(feed or {})
        fetch_list = list(fetch_list or [])
        if not program.ops:
            return []  # startup program: params initialize eagerly

        fetch_vars = []
        for f in fetch_list:
            v = getattr(f, "_data", None)
            v = getattr(v, "_static_var", None) if v is not None else None
            if v is None and isinstance(f, (Variable, Tensor, torch.Tensor)):
                v = f  # a Variable, or a concrete tensor (a parameter)
            if v is None:
                raise TypeError(f"cannot fetch {type(f)}")
            fetch_vars.append(v)

        dev = self._device()
        env: Dict[int, torch.Tensor] = {}
        sig = []
        for name in sorted(feed):
            val = feed[name]
            var = program.vars.get(name)
            dtype = var.dtype if var is not None and var.is_data else None
            raw = val._data if isinstance(val, Tensor) else torch.as_tensor(
                np.asarray(val) if not isinstance(val, torch.Tensor) else val)
            raw = raw.to(device=dev, dtype=dtype or raw.dtype)
            if var is not None:
                env[var.id] = raw
            sig.append((name, tuple(raw.shape), str(raw.dtype)))
        key = (id(program), program._version, tuple(sig), tuple(
            v.id if isinstance(v, Variable) else id(v) for v in fetch_vars))
        if key not in self._cache:
            self._cache[key] = self._build(program, fetch_vars)
        params, opt, loss_var, rng_vars = self._cache[key]

        # a fresh seed per run for every rng placeholder
        gen = default_generator(dev)
        for v in rng_vars:
            env[v.id] = torch.randint(2 ** 62, (), generator=gen,
                                      device=dev, dtype=torch.int64)
        if opt is not None:
            for p in params:
                p.grad = None
        with torch.set_grad_enabled(opt is not None):
            replay(program.ops, env)
        fetches = [env[v.id] if isinstance(v, Variable)
                   else _leaf(v).detach().clone() for v in fetch_vars]
        states = [env[var.id].detach() for _, var in program.state_writes]
        loss = env[loss_var.id] if opt is not None else None
        env.clear()  # the backward frees the activations, as eagerly
        if opt is not None:
            torch.autograd.backward([loss], [torch.ones_like(loss)])
            opt.step()
            for p in params:
                p.grad = None
        # persistable-state write-back: updated values land in the live
        # objects after each run
        with torch.no_grad():
            for (obj, _), val in zip(program.state_writes, states):
                if isinstance(obj, Tensor):
                    obj._data = val
                else:
                    obj.copy_(val)
        if return_numpy:
            return [_host(f) for f in fetches]
        return [Tensor._wrap(f.detach()) for f in fetches]
