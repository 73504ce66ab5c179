"""Control flow of the Paddle surface (counterpart of
``paddle_tpu/jit/control_flow.py``).

Reference: the static ops of fluid/layers/control_flow.py (cond,
while_loop, case, switch_case over operators/controlflow/
conditional_block_op.cc and while_op.cc) and the dygraph_to_static
runtime (convert_operators.py convert_ifelse / convert_while_loop).

In eager mode these run plain Python, as in the JAX package. In static
mode, with a symbolic predicate, index or loop variable, each records one
op into the default program: its branches (or the loop's condition and
body) are traced into sub-programs, and the op picks a branch, or loops,
at replay, over the values the sub-programs read from the enclosing
program. ``scan`` runs ``body_fn`` over the leading axis of ``xs``, in
eager and static mode alike. The JAX package lowers these to
``lax.cond`` / ``lax.while_loop`` / ``lax.switch`` / ``lax.scan`` under
its ``to_static`` capture, which the port has not yet.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.utils._pytree as pytree

from ..core import autograd as AG
from ..core.tensor import Tensor

__all__ = ["cond", "while_loop", "scan", "case", "switch_case"]


def _symbolic_in(*trees) -> bool:
    return AG.recording(pytree.tree_leaves(trees))


class _Branch:
    """``fn`` traced into a sub-program: its ops, its result (a tree whose
    symbolic leaves are Variables) and the Variables it reads from outside
    (``free``); ``args`` are placeholder Variables it takes."""

    def __init__(self, fn, args=()):
        from ..static.program import Program, program_guard, static_var

        self.args = [static_var(a) for a in args]
        self.sub = Program()
        with program_guard(self.sub):
            out = fn(*args)
        leaves, self.spec = pytree.tree_flatten(out)
        self.outs = [static_var(v) or v for v in leaves]
        made = {v.id for op in self.sub.ops for v in op.out_vars}
        made.update(v.id for v in self.args)
        self.free = []
        for i in [i for op in self.sub.ops for i in op.inputs] + self.outs:
            if _is_var(i) and i.id not in made and i not in self.free:
                self.free.append(i)

    def run(self, env, args=()):
        """Replay the sub-program over ``env`` (the free Variables'
        values, by id) with ``args`` bound; returns the result leaves."""
        from ..static.executor import _leaf, replay

        env = dict(env)
        env.update((v.id, a) for v, a in zip(self.args, args))
        replay(self.sub.ops, env)
        return [env[o.id] if _is_var(o) else _leaf(o) for o in self.outs]


def _is_var(v) -> bool:
    from ..static.program import Variable

    return isinstance(v, Variable)


def _placeholder(like, drop_lead=False):
    """A symbolic Tensor of ``like``'s shape (without its leading dim with
    ``drop_lead``) and type, of no program."""
    from ..static.program import Variable, _symbolic, static_var

    v = static_var(like)
    raw = like._data if isinstance(like, Tensor) else like
    shape = v.shape if v is not None else tuple(raw.shape)
    var = Variable(None, shape[1:] if drop_lead else shape, raw.dtype,
                   device=raw.device)
    return _symbolic(var, var.probe(1), True)


def _record(fn, lead, branches, like, name):
    """Record ``fn(*lead_values, *free_values)`` as one op whose outputs
    take the leaves and structure of ``like`` (a traced branch)."""
    from ..static.program import (_symbolic, default_main_program,
                                  static_var)

    free = []
    for b in branches:
        free += [v for v in b.free if v not in free]
    touched = list({id(p): p for b in branches
                    for p in b.sub.all_parameters()}.values())
    specs, pos = [], []
    for i, o in enumerate(like.outs):
        if _is_var(o) or isinstance(o, (Tensor, torch.Tensor)):
            raw = o._data if isinstance(o, Tensor) else o
            specs.append((o.shape, o.dtype, o.device) if _is_var(o)
                         else (tuple(raw.shape), raw.dtype, raw.device))
            pos.append(i)
    inputs = [static_var(t) or t for t in lead] + free
    n_lead = len(lead)

    def op(*vals):
        env = {v.id: x for v, x in zip(free, vals[n_lead:])}
        return fn(list(vals[:n_lead]), env)

    out_vars = default_main_program().record(op, inputs, specs, name,
                                             torch.is_grad_enabled(),
                                             touched)
    leaves = list(like.outs)
    for i, v in zip(pos, out_vars):
        leaves[i] = _symbolic(v, v.probe(1), True)
    return pytree.tree_unflatten(leaves, like.spec)


def _tensors(leaves):
    return [o for o in leaves if isinstance(o, torch.Tensor)]


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """paddle.static.nn.cond: ``true_fn(*operands)`` if ``pred`` else
    ``false_fn(*operands)``; with a symbolic ``pred`` in static mode, one
    recorded op that picks the branch at replay."""
    if isinstance(pred, Tensor) and _symbolic_in(pred, operands):
        args = [_placeholder(o) for o in operands]
        tb, fb = _Branch(true_fn, args), _Branch(false_fn, args)
        if tb.spec != fb.spec:
            raise ValueError("cond: true_fn and false_fn must return the "
                             "same structure")

        def pick(lead, env):
            b = tb if bool(lead[0]) else fb
            return _tensors(b.run(env, lead[1:]))

        return _record(pick, [pred, *operands], [tb, fb], tb, "cond")
    return true_fn(*operands) if pred else false_fn(*operands)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence):
    """paddle.static.nn.while_loop: ``loop_vars = body_fn(*loop_vars)``
    while ``cond_fn(*loop_vars)``; with a symbolic loop variable in static
    mode, one recorded op that loops at replay."""
    if _symbolic_in(loop_vars):
        args = [_placeholder(v) for v in loop_vars]
        cb = _Branch(cond_fn, args)
        bb = _Branch(lambda *a: list(_as_list(body_fn(*a))), args)

        def loop(lead, env):
            cur = lead
            while bool(cb.run(env, cur)[0]):
                cur = bb.run(env, cur)
            return cur

        return list(_record(loop, list(loop_vars), [cb, bb], bb,
                            "while_loop"))
    vars_ = list(loop_vars)
    while bool(cond_fn(*vars_)):
        vars_ = _as_list(body_fn(*vars_))
    return vars_


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def scan(body_fn: Callable, init, xs, length=None):
    """``carry, y = body_fn(carry, x)`` over the leading axis of ``xs`` (a
    Tensor, or a list/tuple of them); returns ``(carry, ys)`` with the
    ``y`` stacked along a new leading axis (the JAX package's
    ``lax.scan`` surfaced at the paddle level)."""
    from .. import ops

    x_leaves, x_spec = pytree.tree_flatten(xs)
    n = int(length if length is not None else x_leaves[0].shape[0])
    if _symbolic_in(init, xs):
        c_leaves, c_spec = pytree.tree_flatten(init)
        c_args = [_placeholder(c) for c in c_leaves]
        x_args = [_placeholder(x, drop_lead=True) for x in x_leaves]
        nc = len(c_args)

        def body(*a):
            c, y = body_fn(pytree.tree_unflatten(list(a[:nc]), c_spec),
                           pytree.tree_unflatten(list(a[nc:]), x_spec))
            return [*pytree.tree_leaves(c), *pytree.tree_leaves(y)]

        bb = _Branch(body, c_args + x_args)

        def loop(lead, env):
            cur, xv, ys = lead[:nc], lead[nc:], []
            for i in range(n):
                out = bb.run(env, cur + [x[i] for x in xv])
                cur, y = out[:nc], out[nc:]
                ys.append(y)
            return cur + [torch.stack(list(col)) for col in zip(*ys)]

        # the op's outputs: the carry's shapes, and each y with the steps
        # in front
        out = _record(loop, c_leaves + x_leaves, [bb],
                      _Stacked(bb.outs, nc, n), "scan")
        c_out, y_out = out[:nc], out[nc:]
        return (pytree.tree_unflatten(c_out, c_spec),
                y_out[0] if len(y_out) == 1 else tuple(y_out))
    carry, ys = init, []
    for i in range(n):
        carry, y = body_fn(carry, pytree.tree_unflatten(
            [x[i] for x in x_leaves], x_spec))
        ys.append(y)
    if isinstance(ys[0], (list, tuple)):
        return carry, type(ys[0])(ops.stack(list(col)) for col in zip(*ys))
    return carry, ops.stack(ys)


class _Stacked:
    """The traced scan body's outputs with each ``y`` given the steps as
    its leading dim: the output description ``_record`` takes."""

    def __init__(self, outs, nc, n):
        from ..static.program import Variable

        self.outs = list(outs[:nc])
        for o in outs[nc:]:
            raw = o._data if isinstance(o, Tensor) else o
            shape = o.shape if _is_var(o) else tuple(raw.shape)
            self.outs.append(Variable(None, (n, *shape), o.dtype,
                                      device=o.device))
        self.spec = pytree.tree_flatten(self.outs)[1]


def case(pred_fn_pairs, default=None):
    """fluid/layers/control_flow.py case: the ``fn`` of the first true
    ``pred``, else ``default()``; with symbolic predicates in static
    mode, nested ``cond`` ops (the last pair's ``fn`` is the default when
    none is given, as in the reference)."""
    pairs = list(pred_fn_pairs)
    if _symbolic_in([p for p, _ in pairs]):
        fallback = default if default is not None else pairs[-1][1]

        def chain(i):
            if i == len(pairs):
                return fallback()
            pred, fn = pairs[i]
            return cond(pred, fn, lambda: chain(i + 1))

        return chain(0)
    for pred, fn in pairs:
        if bool(pred):
            return fn()
    if default is not None:
        return default()
    raise ValueError("no branch taken and no default provided")


def switch_case(branch_index, branch_fns, default=None):
    """paddle.static.nn.switch_case: the branch of ``branch_index`` (a
    dict or (index, fn) pairs, or a list indexed from 0), else
    ``default``; with a symbolic index in static mode, one recorded op
    that picks the branch at replay."""
    fns = dict(branch_fns) if not isinstance(branch_fns, dict) \
        else branch_fns
    if isinstance(branch_fns, (list, tuple)) and branch_fns and callable(
            branch_fns[0]):
        fns = dict(enumerate(branch_fns))
    if _symbolic_in(branch_index):
        keys = sorted(fns)
        branches = [_Branch(fns[k]) for k in keys]
        dflt = _Branch(default) if default is not None else branches[-1]

        def pick(lead, env):
            idx = int(lead[0])
            b = branches[keys.index(idx)] if idx in fns else dflt
            return _tensors(b.run(env))

        return _record(pick, [branch_index], branches + [dflt], branches[0],
                       "switch_case")
    idx = int(branch_index)
    if idx in fns:
        return fns[idx]()
    if default is not None:
        return default()
    raise ValueError(f"no branch for index {idx}")
