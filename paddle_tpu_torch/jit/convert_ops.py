"""Converted-control-flow runtime (counterpart of
``paddle_tpu/jit/convert_ops.py``).

Reference: python/paddle/fluid/dygraph/dygraph_to_static/convert_operators.py
(convert_ifelse :210, convert_while_loop :43, convert_logical_and/or/not,
convert_len) — the functions the AST rewriter targets. Each dispatches at
RUN time: a tensor condition during a ``to_static`` capture -> structured
control flow (``jit.cond`` / ``jit.while_loop`` -> ``torch.cond`` /
torch's ``while_loop``); anything else -> plain Python semantics
(including short-circuit evaluation for and/or).

As in the JAX package, both branches (or a loop's body) must produce
matching tensors for every assigned variable; a mismatch raises (the
analog of the reference's "variable may not be initialized" checks).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core import autograd as AG
from ..core.tensor import Tensor


class _Undefined:
    """Placeholder for a name with no binding before a converted block
    (reference: dygraph_to_static/utils.py UndefinedVar). Any use raises."""

    __slots__ = ("name",)

    def __init__(self, name="<var>"):
        self.name = name

    def _raise(self, *a, **k):
        raise NameError(
            f"local variable '{self.name}' is referenced before assignment "
            "(it is only assigned inside one branch of a converted "
            "if/while)")

    __bool__ = __call__ = __getitem__ = _raise
    __add__ = __radd__ = __sub__ = __mul__ = __iter__ = _raise

    def __getattr__(self, item):
        # AttributeError (not NameError) so hasattr() probes stay probes
        raise AttributeError(item)

    def __repr__(self):
        return f"Undefined({self.name})"


UNDEFINED = _Undefined


def _is_traceable(v):
    if isinstance(v, _Undefined):
        return False
    return isinstance(v, (Tensor, torch.Tensor, int, float, bool))


def _tensor_pred(pred):
    return isinstance(pred, Tensor) and AG.in_trace()


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable,
                   init: Sequence, names: Sequence[str]):
    """convert_operators.py:210. ``init`` holds the current values of
    every name either branch assigns; returns their post-if values as a
    tuple. Slots that are not tensors or numbers (Undefined placeholders,
    Python objects) are closed over rather than passed through the cond;
    a branch that binds one of them to a non-tensor raises, naming the
    variable."""
    if not _tensor_pred(pred):
        return true_fn(*init) if bool(pred) else false_fn(*init)

    from .control_flow import cond as jcond

    live = [i for i, v in enumerate(init) if _is_traceable(v)]

    def wrap(branch):
        def g(*traced_vals):
            full = list(init)
            for i, v in zip(live, traced_vals):
                full[i] = v
            out = branch(*full)
            for i, v in enumerate(out):
                if not _is_traceable(v):
                    raise TypeError(
                        f"converted `if` over a tensor condition: variable "
                        f"'{names[i]}' is bound to non-tensor "
                        f"{type(v).__name__!r} by a branch — both branches "
                        "must produce tensors for every assigned variable "
                        "(reference convert_ifelse requires the same)")
            return tuple(out)

        return g

    return jcond(pred, wrap(true_fn), wrap(false_fn),
                 *[init[i] for i in live])


def convert_while_loop(test_fn: Callable, body_fn: Callable,
                       init: Sequence, names: Sequence[str]):
    """convert_operators.py:43. Dispatch on the FIRST test evaluation: a
    tensor during a capture -> ``jit.while_loop``; else plain Python."""
    first = test_fn(*init)
    if not _tensor_pred(first):
        vals = tuple(init)
        cond = bool(first)
        while cond:
            vals = tuple(body_fn(*vals))
            cond = bool(test_fn(*vals))
        return vals

    for i, v in enumerate(init):
        if not _is_traceable(v):
            raise TypeError(
                f"converted `while` over a tensor condition: loop variable "
                f"'{names[i]}' is {type(v).__name__!r} before the loop — "
                "every variable assigned in the body must be a tensor "
                "before the loop starts (initialize it)")
    from .control_flow import while_loop as jwhile

    return tuple(jwhile(test_fn, body_fn, list(init)))


def convert_len(seq):
    """convert_operators.py convert_len: tensor -> leading dim."""
    if isinstance(seq, Tensor):
        return seq.shape[0]
    try:
        return len(seq)
    except TypeError:
        return len(list(seq))


def convert_to_sequence(it):
    """Materialize a for-loop iterable into something indexable (tensors
    and sequences pass through; views/generators become lists)."""
    if isinstance(it, Tensor) or hasattr(it, "__getitem__"):
        return it
    return list(it)


def convert_getitem(seq, i):
    if isinstance(seq, (list, tuple)) and isinstance(i, Tensor):
        raise TypeError(
            "indexing a python list with a tensor loop index inside a "
            "converted loop; convert the list to a tensor first")
    return seq[i]


def _as_tensor(v, like):
    return v if isinstance(v, Tensor) else Tensor._wrap(
        torch.as_tensor(v, device=like._data.device))


def convert_logical_and(x, y_fn: Callable):
    """Short-circuit-preserving ``and`` (convert_operators.py
    convert_logical_and): Python values keep Python semantics and lazy
    evaluation; tensors evaluate both sides (a captured program has no
    short-circuit)."""
    if isinstance(x, Tensor):
        y = y_fn()
        if isinstance(y, Tensor) or _tensor_pred(x):
            from ..ops import logic

            return logic.logical_and(x, _as_tensor(y, x))
        return y if bool(x) else x
    if not x:
        return x
    return y_fn()


def convert_logical_or(x, y_fn: Callable):
    if isinstance(x, Tensor):
        y = y_fn()
        if isinstance(y, Tensor) or _tensor_pred(x):
            from ..ops import logic

            return logic.logical_or(x, _as_tensor(y, x))
        return x if bool(x) else y
    if x:
        return x
    return y_fn()


def convert_logical_not(x):
    if isinstance(x, Tensor):
        from ..ops import logic

        return logic.logical_not(x)
    return not x


# -- recursive callee conversion (convert_operators.py convert_call) --------

_SKIP_MODULE_PREFIXES = (
    "paddle_tpu_torch", "torch", "numpy", "builtins", "math", "functools",
    "itertools", "operator", "np",
)


def convert_call(fn):
    """Convert a CALLED function lazily (dygraph_to_static convert_call):
    plain user functions and methods get the same AST rewrite as the
    decorated entry point, so tensor control flow in undecorated helpers
    is captured too. Framework and library callables, classes, Layers,
    builtins and ``jit.not_to_static``-marked functions pass through
    untouched.

    The parse and compile are cached per CODE OBJECT inside
    ``convert_to_static``; the function itself is rebuilt per call over
    the original's live globals and closure, so no per-instance cache pins
    stale scopes."""
    from ..nn.layer import Layer

    raw = getattr(fn, "__func__", fn)
    if not callable(fn) or isinstance(fn, (type, Layer)):
        return fn
    if not hasattr(raw, "__code__"):
        return fn  # builtins / C extensions
    mod = getattr(raw, "__module__", "") or ""
    if mod.split(".")[0] in _SKIP_MODULE_PREFIXES:
        return fn
    from .ast_transform import convert_to_static

    try:
        return convert_to_static(fn)
    except Exception:
        return fn
