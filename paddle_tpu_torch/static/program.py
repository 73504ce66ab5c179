"""Static-graph ``Program``: the deferred-execution graph builder
(counterpart of ``paddle_tpu/static/program.py``).

A ``Program`` records ops as (function, inputs, output variables): the
same torch functions the eager ops and layers run. A symbolic ``Tensor``
holds a fake tensor (``torch._subclasses.fake_tensor``) that carries its
``Variable`` in ``_static_var``; when one reaches ``core.autograd.apply``
(every op of ``ops/``) or ``core.tensor.tensor_boundary`` (every
functional, and every ``forward`` of the package's layers), the call is
recorded here instead of run. Concrete tensors the call touches
(parameters, buffers, captured constants) become program leaves, resolved
from the live objects at run time, so optimizer updates are visible
across runs. A layer recorded as one op hides its parameters in its
closure: the shape probe observes the parameters its torch calls take
(the same ``TorchFunctionMode``), and they are recorded beside its inputs
(``StaticOp.touched``), so ``Program.all_parameters()`` finds them.

Shape inference, the counterpart of ``jax.eval_shape``: the function runs
once under one process-wide ``FakeTensorMode`` on probe tensors, with the
``-1`` dims of the placeholders at extent 1, and again at extent 2 when
there are such dims; output dims that move with the probe are recorded as
``-1``. A probe never computes a value: the kernels are ``torch.library``
custom ops (``ops/kernels``), whose fake implementations give their
outputs' shapes and types, and each real tensor a probe's torch call takes
(a parameter, a buffer, a captured constant) goes in as a fake of it (a
``TorchFunctionMode``, which sees the custom ops' calls too), so an
in-place write lands on the fake.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _disable_current_modes

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor

__all__ = [
    "Program", "Variable", "data", "program_guard",
    "default_main_program", "default_startup_program",
]

_fake_mode = None


def fake_mode():
    """The process-wide ``FakeTensorMode`` every symbolic tensor and probe
    belongs to (made on first use)."""
    global _fake_mode
    if _fake_mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    return _fake_mode


class Variable:
    """A symbolic graph edge (framework.py Variable analog): a name, a
    shape with ``-1`` for dims unknown until a feed, a torch dtype and the
    device its values live on."""

    _counter = 0

    def __init__(self, name: Optional[str], shape, dtype, is_data=False,
                 device=None):
        Variable._counter += 1
        self.id = Variable._counter
        self.name = name or f"tmp_var_{self.id}"
        self.shape = tuple(-1 if d is None else int(d) for d in shape)
        self.dtype = dtype
        self.device = device
        self.is_data = is_data  # a feed placeholder
        self.is_rng = False     # a per-run seed feed (see rng_feed)

    def aval(self, dyn: int = 1) -> tuple:
        """The shape with dynamic (-1) dims placed at ``dyn``."""
        return tuple(dyn if d < 0 else d for d in self.shape)

    def probe(self, dyn: int = 1) -> torch.Tensor:
        """A fake tensor of :meth:`aval` ``(dyn)``."""
        with fake_mode():
            return torch.empty(self.aval(dyn), dtype=self.dtype,
                               device=self.device)

    def __repr__(self):
        return f"Variable({self.name}, shape={list(self.shape)})"


class StaticOp:
    """One recorded op: ``fn`` over the resolved ``inputs`` -> a result
    whose tensors (in ``torch.utils._pytree`` order) are ``out_vars``.

    Inputs are Variables (edges), ``Tensor`` objects (resolved to their
    current ``_data``), torch tensors (parameters and buffers, which the
    optimizer updates in place) or constants. ``touched`` are the
    parameters and buffers the call reads through its closure (a layer's
    own, as the shape probe saw them taken); they are not passed to
    ``fn``. ``grad_enabled`` is the grad
    mode at record time, which the replay keeps."""

    def __init__(self, fn: Callable, inputs: Sequence, out_vars: List[Variable],
                 name: str, grad_enabled: bool = True, touched=()):
        self.fn = fn
        self.inputs = list(inputs)
        self.out_vars = out_vars
        self.name = name
        self.grad_enabled = grad_enabled
        self.touched = list(touched)


class Program:
    """framework.py Program. One block: control flow records sub-programs
    inside its op (``jit/control_flow.py``)."""

    def __init__(self):
        self.ops: List[StaticOp] = []
        self.vars = {}
        # recorded `opt.minimize(loss)` directives: (optimizer, loss_var)
        self.optimize_directives = []
        # persistable-state writes: (live tensor, producing Variable); the
        # executor writes the variable's value into the live object after
        # each run (the scope-variable update of executor.cc)
        self.state_writes = []
        self._version = 0

    def _add_var(self, var: Variable):
        self.vars[var.name] = var
        return var

    def record(self, fn, inputs, out_specs, name, grad_enabled=True,
               touched=()):
        """Append an op; ``out_specs`` are (shape, dtype, device) of its
        output tensors. Returns their Variables."""
        out_vars = [self._add_var(Variable(None, s, d, device=dev))
                    for s, d, dev in out_specs]
        self.ops.append(StaticOp(fn, inputs, out_vars, name, grad_enabled,
                                 touched))
        self._version += 1
        return out_vars

    def global_block(self):
        return self

    def all_parameters(self):
        """The parameters the ops take, in the order they are first taken
        (the JAX package lists its ops' parameter inputs so)."""
        seen, out = set(), []
        for op in self.ops:
            for i in (*op.touched, *op.inputs):
                if isinstance(i, torch.nn.Parameter) and id(i) not in seen:
                    seen.add(id(i))
                    out.append(i)
        return out

    def list_vars(self):
        return list(self.vars.values())

    def record_state_write(self, tensor, symbolic):
        var = static_var(symbolic)
        if var is None:
            raise ValueError("state write source must be symbolic")
        self.state_writes.append((tensor, var))
        self._version += 1

    def clone(self, for_test=False):
        p = Program()
        p.ops = list(self.ops)
        p.vars = dict(self.vars)
        p.state_writes = list(self.state_writes)
        if not for_test:
            p.optimize_directives = list(self.optimize_directives)
        return p

    def __repr__(self):
        return (f"Program(ops={len(self.ops)}, vars={len(self.vars)}, "
                f"optimized={bool(self.optimize_directives)})")


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    """framework.py program_guard."""
    global _main_program, _startup_program
    prev_m, prev_s = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_m, prev_s


def _symbolic(var: Variable, raw: torch.Tensor, differentiable=False
              ) -> Tensor:
    raw._static_var = var
    if differentiable and (raw.is_floating_point() or raw.is_complex()):
        raw.requires_grad_(True)
    return Tensor._wrap(raw)


def data(name: str, shape, dtype="float32", lod_level=0) -> Tensor:
    """paddle.static.data: declare a feed placeholder on the package's
    device. Returns a symbolic Tensor; ops consuming it record into the
    default main program."""
    from . import _static_mode_on

    if not _static_mode_on():
        raise RuntimeError(
            "paddle.static.data requires static mode: call "
            "paddle.enable_static() first"
        )
    var = Variable(name, shape, convert_dtype(dtype), is_data=True,
                   device=resolve_device(None))
    _main_program._add_var(var)
    return _symbolic(var, var.probe(1))


def static_var(t) -> Optional[Variable]:
    """The Variable of a symbolic ``Tensor`` or of its fake tensor, else
    None."""
    raw = t._data if isinstance(t, Tensor) else t
    return getattr(raw, "_static_var", None) \
        if isinstance(raw, torch.Tensor) else None


def is_symbolic(t) -> bool:
    return static_var(t) is not None


def rng_feed() -> Tensor:
    """A per-run seed placeholder (an int64 scalar on the package's
    device). The executor feeds each one a fresh draw from the package's
    generator of its device on every run, so a random op that takes its
    seed from it draws anew each ``exe.run`` (the reference reseeds its
    generator per dropout kernel launch, operators/dropout_op.h)."""
    var = Variable(None, (), torch.int64, device=resolve_device(None))
    var.is_rng = True
    _main_program._add_var(var)
    return _symbolic(var, var.probe(1))


class _Touched(torch.overrides.TorchFunctionMode):
    """A probe's torch calls: each real tensor they take (a parameter, a
    buffer, a captured constant) goes in as a fake of it, made once per
    probe, so no real tensor reaches the fake mode's dispatch (which
    refuses some, as a ``Parameter`` subclass) or is written; the
    parameters are collected in the order they are first taken."""

    def __init__(self):
        super().__init__()
        self.params = {}
        self._fakes = {}

    def _fake(self, a):
        if not isinstance(a, torch.Tensor) or isinstance(a, FakeTensor):
            return a
        if isinstance(a, torch.nn.Parameter):
            self.params.setdefault(id(a), a)
        f = self._fakes.get(id(a))
        if f is None:
            with _disable_current_modes():
                plain = a.detach()
            f = self._fakes[id(a)] = (a, fake_mode().from_tensor(plain))
        return f[1]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map(self._fake, (args, kwargs or {}))
        return func(*args, **kwargs)


def _probe(fn, inputs, dyn):
    """``fn`` on probe tensors of extent ``dyn``: (result, the parameters
    it took)."""
    vals = [i.probe(dyn) if isinstance(i, Variable)
            else i._data if isinstance(i, Tensor) else i for i in inputs]
    with fake_mode(), torch.no_grad(), _Touched() as seen:
        return fn(*vals), list(seen.params.values())


def _tensor_leaves(out) -> list:
    return [o for o in pytree.tree_leaves(out) if isinstance(o, torch.Tensor)]


def record_apply(raw_fn, tensors, name, differentiable=True, params=()):
    """The static-mode hook of ``apply`` and ``tensor_boundary``: symbolic
    inputs mean 'record into the program' instead of executing
    (LayerHelper.append_op analog). ``tensors`` are ``raw_fn``'s
    arguments: fake tensors of symbolic Tensors, ``Tensor`` objects, torch
    tensors or constants. Returns ``raw_fn``'s result structure with a
    symbolic ``Tensor`` in place of each tensor.

    The parameters the probe's torch calls take (a layer's own, which its
    closure reads) are recorded beside the inputs, in the order they are
    first taken, then those of ``params`` the probe did not see (a
    layer's parameter that this call leaves unused): ``Program.
    all_parameters()`` lists them so.

    Dynamic-dim propagation: placeholder dims declared -1/None are
    shape-inferred TWICE (at probe extents 1 and 2); output dims that
    move with the probe are recorded as -1."""
    inputs, any_dyn = [], False
    for t in tensors:
        v = static_var(t)
        if v is not None:
            inputs.append(v)
            any_dyn = any_dyn or any(d < 0 for d in v.shape)
        else:
            inputs.append(t)
    grad_on = torch.is_grad_enabled()
    out1, touched = _probe(raw_fn, inputs, 1)
    seen = {id(p) for p in touched}
    touched += [p for p in params if id(p) not in seen]
    outs1 = _tensor_leaves(out1)
    dyn_masks = [None] * len(outs1)
    if any_dyn:
        try:
            outs2 = _tensor_leaves(_probe(raw_fn, inputs, 2)[0])
            dyn_masks = [
                tuple(a != b for a, b in zip(o1.shape, o2.shape))
                if o1.dim() == o2.dim() else None
                for o1, o2 in zip(outs1, outs2)
            ]
        except Exception:
            pass  # op incompatible with the probe extent: static shapes
    out_vars = _main_program.record(
        raw_fn, inputs, [(tuple(o.shape), o.dtype, o.device) for o in outs1],
        name or "op", grad_on, touched)
    for v, mask in zip(out_vars, dyn_masks):
        if mask:
            v.shape = tuple(-1 if d else s for s, d in zip(v.shape, mask))
    wrapped = iter([_symbolic(v, v.probe(1), differentiable and grad_on)
                    for v in out_vars])
    leaves, spec = pytree.tree_flatten(out1)
    return pytree.tree_unflatten(
        [next(wrapped) if isinstance(o, torch.Tensor) else o for o in leaves],
        spec)


def record_call(fn, args, kwargs, name):
    """Record ``fn(*args, **kwargs)`` (a torch-native function behind
    ``tensor_boundary``) as one op: each ``Tensor`` or torch tensor among
    the arguments (in lists, tuples and dicts too) is an input; a layer's
    ``forward`` (its first argument a module) is named after its class,
    and every parameter of the layer is recorded as touched."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    pos = [i for i, v in enumerate(leaves)
           if isinstance(v, (Tensor, torch.Tensor))]
    inputs = [leaves[i] for i in pos]
    params = ()
    if args and isinstance(args[0], torch.nn.Module):
        name = type(args[0]).__name__
        params = args[0].parameters()

    def call(*vals):
        full = list(leaves)
        for i, v in zip(pos, vals):
            full[i] = v
        a, kw = pytree.tree_unflatten(full, spec)
        return fn(*a, **kw)

    return record_apply(call, inputs, name, params=params)


def set_program_parameters(program: Program, params) -> None:
    """Copy another program's parameters into ``program``'s: ``params``
    are ``(name, array)`` pairs in that program's ``all_parameters()``
    order (a ``paddle_tpu`` Program's, as numpy arrays), matched to this
    one's by position; the names and shapes must agree. The static
    counterpart of ``Layer.set_state_dict``'s weight carry."""
    own = program.all_parameters()
    params = list(params)
    if len(params) != len(own):
        raise ValueError(f"set_program_parameters: {len(params)} values "
                         f"for {len(own)} parameters")
    with torch.no_grad():
        for i, ((name, value), p) in enumerate(zip(params, own)):
            v = torch.as_tensor(np.array(value))
            if name != p.name or tuple(v.shape) != tuple(p.shape):
                raise ValueError(
                    f"set_program_parameters: parameter {i} is "
                    f"{p.name!r} {tuple(p.shape)}, the value "
                    f"{name!r} {tuple(v.shape)}")
            p.copy_(v.to(device=p.device, dtype=p.dtype))
