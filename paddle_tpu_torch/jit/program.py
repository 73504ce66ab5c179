"""Program capture: the ``to_static`` engine (counterpart of
``paddle_tpu/jit/program.py``).

Reference mapping (SURVEY.md §3.5): ``@declarative`` / ProgramTranslator
(program_translator.py:233,582,689) is :class:`StaticFunction`, a program
cache keyed by the input signature; ``PartialProgramLayer`` and the
``run_program`` op (partial_program.py:206) are :class:`_CapturedProgram`.

A cache entry is a ``torch.export`` capture (non-strict) of the converted
function: the parameters and buffers of every involved Layer are lifted
to inputs of the captured program, beside the tensor arguments. The
kernels are ``torch.library`` custom ops (``ops/kernels``), so the capture
records each kernel as itself, and their registered autograd formulas
give a captured program its gradient. A call runs the captured program
(``ExportedProgram.module()``) on the Layers' LIVE parameters and
buffers, under torch's autograd: an optimizer step is seen by the next
call, gradients reach every parameter's ``.grad``, and a buffer the
function writes in place (batch norm's running statistics) is written in
the live Layer; a buffer the function rebinds comes back as an extra
output and is rebound in the live Layer after the call.

Random draws inside the capture go to the package's draw op
(``core/random.py``), which draws from the package's generator at every
run: dropout's masks are fresh on each call, and no draw reads PyTorch's
global generator (the JAX package passes a fresh key per call).

Tensor control flow: unless ``PADDLE_TPU_NO_AST=1``, the function is first
rewritten by ``jit/ast_transform.py`` so that a tensor ``if``/``while``/
``for`` goes through ``jit/control_flow.py``, which lowers to
``torch.cond`` / torch's ``while_loop`` during a capture. A capture that
torch cannot make (a data-dependent Python branch it cannot lower) raises,
naming the function; it never runs unconverted in silence.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import autograd as AG
from ..core.tensor import Tensor
from ..nn.layer import Layer

__all__ = ["InputSpec", "StaticFunction", "to_static", "declarative"]


class InputSpec:
    """Input signature (reference: python/paddle/static/input.py
    InputSpec). ``None`` dims are allowed; the program cache keys on the
    concrete shapes seen, and ``jit.save`` captures a ``None`` dim at 1."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        from ..core.dtype import dtype_name

        raw = tensor._data if isinstance(tensor, Tensor) else tensor
        return cls(tuple(raw.shape), dtype_name(raw.dtype), name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _collect_layers(obj, fn, explicit=None) -> List[Layer]:
    """The Layers whose parameters and buffers a capture lifts to inputs.

    Preferred: pass them explicitly (``to_static(fn, layers=[...])``). The
    implicit scan reads the function's closure cells, its bound ``self``
    and its globals, two levels into dicts, lists, tuples and object
    ``__dict__``s (the reference's rule)."""
    layers: List[Layer] = []
    seen = set()

    def add(layer):
        if id(layer) not in seen:
            seen.add(id(layer))
            layers.append(layer)

    for layer in explicit or ():
        add(layer)
    if isinstance(obj, Layer):
        add(obj)
    if fn is not None and not isinstance(obj, Layer):
        def scan(v, depth):
            if isinstance(v, Layer):
                add(v)
                return
            if depth <= 0:
                return
            if isinstance(v, dict):
                for x in v.values():
                    scan(x, depth - 1)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x, depth - 1)

        for cell in getattr(fn, "__closure__", None) or ():
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if v is not None:
                scan(v, 2)
                if not isinstance(v, Layer) and hasattr(v, "__dict__"):
                    scan(vars(v), 1)
        bound_self = getattr(fn, "__self__", None)
        if bound_self is not None:
            scan(bound_self, 1)
            if not isinstance(bound_self, Layer) and hasattr(
                    bound_self, "__dict__"):
                scan(vars(bound_self), 2)
        for v in list(getattr(fn, "__globals__", {}).values()):
            scan(v, 2)
    return layers


class _State:
    """The parameters and buffers of ``layers`` in a stable order, and
    every (module dict, name) slot that holds each (a tied weight has
    two)."""

    def __init__(self, layers: Sequence[Layer]):
        self.params: List[torch.Tensor] = []
        self.buffers: List[torch.Tensor] = []
        index: Dict[int, Tuple[str, int]] = {}
        self.slots: List[Tuple[dict, str, str, int]] = []
        modules = {}
        for layer in layers:
            for m in layer.modules():
                modules.setdefault(id(m), m)
        for kind, attr, out in (("p", "_parameters", self.params),
                                ("b", "_buffers", self.buffers)):
            for m in modules.values():
                d = getattr(m, attr)
                for name, t in d.items():
                    if t is None:
                        continue
                    if id(t) not in index:
                        index[id(t)] = (kind, len(out))
                        out.append(t)
                    k, i = index[id(t)]
                    self.slots.append((d, name, k, i))

    def live(self) -> List[torch.Tensor]:
        """The current parameters and buffers, in lifted order."""
        return [*self.params, *self.buffers]

    def swap(self, params, buffers):
        """Put ``params`` / ``buffers`` in every slot; returns what the
        slots held."""
        saved = [d[name] for d, name, _, _ in self.slots]
        for d, name, kind, i in self.slots:
            d[name] = params[i] if kind == "p" else buffers[i]
        return saved

    def restore(self, saved):
        for (d, name, _, _), t in zip(self.slots, saved):
            d[name] = t


def _flatten_out(out):
    """Nested (tuple/list/dict/Tensor/tensor) outputs -> (tensor leaves,
    treedef)."""
    leaves = []

    def rec(o):
        if isinstance(o, (Tensor, torch.Tensor)):
            leaves.append(o._data if isinstance(o, Tensor) else o)
            return ("t", None)
        if isinstance(o, tuple):
            return ("tuple", [rec(v) for v in o])
        if isinstance(o, list):
            return ("list", [rec(v) for v in o])
        if isinstance(o, dict):
            return ("dict", [(k, rec(v)) for k, v in o.items()])
        return ("const", o)

    return leaves, rec(out)


def _unflatten_out(leaves: List, treedef, wrap: bool = True):
    """The outputs' structure again, each tensor a ``Tensor`` (or the
    torch tensor itself without ``wrap``)."""
    leaves = list(leaves)

    def rec(td):
        kind, spec = td
        if kind == "t":
            t = leaves.pop(0)
            return Tensor._wrap(t) if wrap else t
        if kind == "tuple":
            return tuple(rec(s) for s in spec)
        if kind == "list":
            return [rec(s) for s in spec]
        if kind == "dict":
            return {k: rec(s) for k, s in spec}
        return spec

    return rec(treedef)


class _Traced(torch.nn.Module):
    """What ``torch.export`` captures: the function over (parameters,
    buffers, tensor arguments) as flat tensors. It holds no state of its
    own, so every tensor of the Layers enters as an input."""

    def __init__(self, prog):
        super().__init__()
        object.__setattr__(self, "_prog", prog)

    def forward(self, *flat):
        return self._prog._program(flat)


class _CapturedProgram:
    """One entry of the program cache: the capture of ``fn`` at one input
    signature and one set of training flags."""

    def __init__(self, fn, layers, static_kwargs: Dict[str, Any],
                 arg_template: Tuple, name: str = "fn"):
        self.fn = fn
        self.name = name
        self.static_kwargs = static_kwargs
        self.arg_template = arg_template
        self.state = _State(layers)
        self.out_treedef = None
        self.n_out = 0
        # buffers the function rebinds (their new values come back as
        # extra outputs): indices into state.buffers
        self.rebound: List[int] = []
        self.module = None
        self.exported = None
        self.capture_s = 0.0

    @property
    def params(self):
        return self.state.params

    @property
    def buffers(self):
        return self.state.buffers

    def _rebuild_args(self, raws):
        raws = list(raws)
        return [Tensor._wrap(raws.pop(0)) if kind == "tensor" else val
                for kind, val in self.arg_template]

    def _program(self, flat):
        """The function as the capture sees it: (parameters, buffers,
        inputs) -> (outputs, rebound buffers)."""
        n_p, n_b = len(self.params), len(self.buffers)
        p_raw, b_raw = flat[:n_p], flat[n_p:n_p + n_b]
        saved = self.state.swap(p_raw, b_raw)
        try:
            with AG.trace_mode():
                out = self.fn(*self._rebuild_args(flat[n_p + n_b:]),
                              **self.static_kwargs)
            leaves, self.out_treedef = _flatten_out(out)
            self.n_out = len(leaves)
            self.rebound = []
            current = {}
            for d, name, kind, i in self.state.slots:
                if kind == "b":
                    current.setdefault(i, d[name])
            for i, t in current.items():
                if t is not b_raw[i]:
                    self.rebound.append(i)
            return tuple(leaves) + tuple(current[i] for i in self.rebound)
        finally:
            self.state.restore(saved)

    def capture(self, tensor_args: Sequence[Tensor]):
        """``torch.export`` of the function at these arguments."""
        import time

        t0 = time.perf_counter()
        example = [t.detach() for t in self.state.live()] + [
            a._data.detach() for a in tensor_args]
        try:
            self.exported = torch.export.export(
                _Traced(self), tuple(example), strict=False)
        except Exception as e:
            if not type(e).__module__.startswith("torch"):
                raise  # the function's own error
            first = (str(e).strip().splitlines() or [""])[0]
            raise RuntimeError(
                f"to_static: torch.export could not capture {self.name} "
                f"({type(e).__name__}: {first}); a branch or loop on a "
                "tensor must go through paddle.jit.cond / while_loop or "
                "the AST conversion (PADDLE_TPU_NO_AST unset)") from e
        # the example inputs are the live weights at capture time: the
        # program keeps no reference to them, and a saved one no copy
        self.exported.example_inputs = None
        self.module = self.exported.module()
        self.capture_s = time.perf_counter() - t0

    def __call__(self, tensor_args: Sequence[Tensor], wrap: bool = True):
        """Run the capture on the live weights and ``tensor_args``."""
        flat = self.state.live() + [a._data for a in tensor_args]
        outs = self.module(*flat)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        outs = list(outs)
        for i, new in zip(self.rebound, outs[self.n_out:]):
            self.buffers[i] = new.detach()
            for d, name, kind, j in self.state.slots:
                if kind == "b" and j == i:
                    d[name] = self.buffers[i]
        return _unflatten_out(outs[:self.n_out], self.out_treedef, wrap)


def _hashable(v):
    try:
        hash(v)
        return True
    except TypeError:
        return False


class StaticFunction:
    """The ``to_static`` wrapper (program_translator.py:233
    StaticFunction): a program cache keyed by the tensor arguments'
    shapes and types, the other arguments, and every sublayer's
    ``training`` flag."""

    def __init__(self, fn, layer: Optional[Layer] = None, input_spec=None,
                 build_strategy=None, layers=None):
        if os.environ.get("PADDLE_TPU_NO_AST") != "1":
            # AST conversion (program_translator.py:756): tensor-dependent
            # if/while/for go through jit/control_flow.py; a source it
            # cannot rewrite is captured as it is
            from .ast_transform import convert_to_static

            fn = convert_to_static(fn)
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._explicit_layers = list(layers) if layers else None
        self._layers_found: Optional[List[Layer]] = None
        self._cache: Dict[Tuple, _CapturedProgram] = {}
        self._lock = threading.Lock()
        self.__name__ = getattr(fn, "__name__", "static_fn")
        # the decorated function's module (a user's Layer keeps its own
        # forward's conversion rules, nn/layer.py)
        self.__module__ = getattr(fn, "__module__", None)

    def __get__(self, instance, owner):
        # @to_static on a method: one wrapper per instance
        if instance is None:
            return self
        bound = StaticFunction(
            self._fn.__get__(instance, owner), layer=instance,
            input_spec=self._input_spec, layers=self._explicit_layers)
        object.__setattr__(instance, self.__name__, bound)
        return bound

    @staticmethod
    def _split_args(args):
        tensor_args, template = [], []
        for a in args:
            if isinstance(a, Tensor):
                tensor_args.append(a)
                template.append(("tensor", None))
            elif isinstance(a, torch.Tensor):
                tensor_args.append(Tensor._wrap(a))
                template.append(("tensor", None))
            else:
                template.append(("const", a))
        return tensor_args, tuple(template)

    @staticmethod
    def _cache_key(tensor_args, template, kwargs, layers):
        sig = tuple((tuple(t._data.shape), str(t._data.dtype),
                     str(t._data.device)) for t in tensor_args)
        consts = tuple((k, v if _hashable(v) else repr(v))
                       for k, v in sorted(kwargs.items()))
        modes = tuple(m.training for layer in layers
                      for m in layer.sublayers(True))
        tmpl = tuple(v if _hashable(v) else repr(v)
                     for k, v in template if k == "const")
        return (sig, consts, modes, tmpl)

    def __call__(self, *args, **kwargs):
        if any(isinstance(v, (Tensor, torch.Tensor))
               for v in kwargs.values()):
            raise TypeError(f"to_static {self.__name__}: pass tensors "
                            "positionally (keyword arguments are constants "
                            "of the program)")
        tensor_args, template = self._split_args(args)
        layers = self._layers_found
        if layers is None:
            layers = self._layers_found = _collect_layers(
                self._layer, self._fn, self._explicit_layers)
        key = self._cache_key(tensor_args, template, kwargs, layers)
        prog = self._cache.get(key)
        if prog is None:
            with self._lock:
                layers = self._layers_found = _collect_layers(
                    self._layer, self._fn, self._explicit_layers)
                key = self._cache_key(tensor_args, template, kwargs, layers)
                prog = self._cache.get(key)
                if prog is None:
                    prog = _CapturedProgram(self._fn, layers, dict(kwargs),
                                            template, self.__name__)
                    prog.capture(tensor_args)
                    self._cache[key] = prog
        # Tensor in, Tensor out; torch tensors in (a torch-native
        # caller), torch tensors out
        return prog(tensor_args, wrap=not any(
            isinstance(a, torch.Tensor) for a in args) or any(
            isinstance(a, Tensor) for a in args))

    @property
    def program_cache(self):
        return self._cache

    def concrete_program(self, *args, **kwargs):
        raise NotImplementedError


def to_static(function=None, input_spec=None, build_strategy=None,
              property_=False, layers=None):
    """paddle.jit.to_static (reference: fluid/dygraph/jit.py:160
    declarative), on a Layer (its ``forward`` is replaced), a method or a
    function. ``layers`` lists Layers whose state the program lifts
    (recommended for functions holding Layers in containers)."""

    def decorate(fn):
        if isinstance(fn, Layer):
            wrapped = StaticFunction(fn.forward, layer=fn,
                                     input_spec=input_spec, layers=layers)
            fn.forward = wrapped
            return fn
        return StaticFunction(fn, input_spec=input_spec, layers=layers)

    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static
