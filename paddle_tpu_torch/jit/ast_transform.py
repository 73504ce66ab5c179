"""Dygraph-to-static AST conversion (counterpart of
``paddle_tpu/jit/ast_transform.py``).

Reference: python/paddle/fluid/dygraph/dygraph_to_static/ast_transformer.py
(DygraphToStaticAst — 15 transformers) + program_translator.py:756
(convert_to_static). The subset built here covers the transformers that
matter for tensor-dependent control flow:

  - ReturnTransformer   (pass 1)  early `return` -> flag + value locals;
                        statements after a possible return are wrapped in
                        `if not flag:` so the rewrite composes with the
                        control-flow conversion below
  - IfElseTransformer   (pass 2)  -> convert_ifelse(pred, true, false, ...)
  - LoopTransformer     (pass 2)  while -> convert_while_loop; for ->
                        index-while over convert_len/convert_getitem
  - LogicalTransformer  (pass 2)  and/or/not -> convert_logical_* (python
                        short-circuit preserved)

Everything else (call graphs, closures, defaults) is left to Python: the
capture (``torch.export``) runs straight-line code as it is; only control
flow on a tensor needs rewriting, onto ``jit/control_flow.py``, which
lowers it to ``torch.cond`` / torch's ``while_loop`` during a capture.

`convert_to_static(fn)` returns the transformed function
(``.__ptu_converted__ == True``) or `fn` unchanged when the source is
unavailable or uses constructs outside the subset (break/continue under a
tensor condition, return inside a converted loop, while/else); for a
tensor condition there the capture fails on the data-dependent branch and
``to_static`` raises, naming the function.

Scoping: the transformed def is compiled inside a synthetic outer
function with the original free variables as parameters, then called
with a snapshot of the closure cells; globals are fn.__globals__
extended with the convert_ops runtime under __ptt_* names (the JAX
package installs its own under __ptu_* names: a module that converts
functions through both packages keeps both runtimes apart). The marks on
functions keep the JAX package's names: ``__ptu_converted__`` on a
rewritten function, ``__ptu_not_to_static__`` from ``jit.not_to_static``.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import List, Set

from . import convert_ops

_RT = {
    "__ptt_ifelse__": convert_ops.convert_ifelse,
    "__ptt_while__": convert_ops.convert_while_loop,
    "__ptt_len__": convert_ops.convert_len,
    "__ptt_getitem__": convert_ops.convert_getitem,
    "__ptt_to_seq__": convert_ops.convert_to_sequence,
    "__ptt_and__": convert_ops.convert_logical_and,
    "__ptt_or__": convert_ops.convert_logical_or,
    "__ptt_not__": convert_ops.convert_logical_not,
    "__ptt_undef__": convert_ops.UNDEFINED,
    "__ptt_call__": convert_ops.convert_call,
}

_RET_FLAG = "__ptt_ret_flag__"
_RET_VAL = "__ptt_ret_val__"


class _Unsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# ast building helpers
# ---------------------------------------------------------------------------


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _const(v):
    return ast.Constant(value=v)


def _call_rt(fname, *args):
    return ast.Call(func=_name(fname), args=list(args), keywords=[])


def _loc(new, like):
    ast.copy_location(new, like)
    ast.fix_missing_locations(new)
    return new


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def _assigned_names(nodes: List[ast.stmt]) -> List[str]:
    """Names bound by assignments/for-targets in `nodes`, first-binding
    order (stable operand order). Nested function/lambda/comprehension
    scopes are opaque."""
    out: List[str] = []
    seen: Set[str] = set()

    def add(name):
        # generated __ptt_*__ helpers are block-local implementation
        # artifacts of an earlier (inner) conversion, never user state
        if name.startswith("__ptt_") and name != _RET_VAL:
            return
        if name not in seen:
            seen.add(name)
            out.append(name)

    def add_target(t):
        if isinstance(t, ast.Name):
            add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add_target(e)
        elif isinstance(t, ast.Starred):
            add_target(t.value)

    def walk(n):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(n.name)
            return
        if isinstance(n, (ast.Lambda, ast.ListComp, ast.SetComp,
                          ast.DictComp, ast.GeneratorExp)):
            return
        if isinstance(n, ast.Assign):
            for t in n.targets:
                add_target(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            add_target(n.target)
        elif isinstance(n, ast.For):
            add_target(n.target)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            add_target(n.optional_vars)
        for c in ast.iter_child_nodes(n):
            walk(c)

    for n in nodes:
        walk(n)
    return out


def _contains(nodes, kinds) -> bool:
    return any(
        isinstance(sub, kinds) for n in nodes for sub in ast.walk(n)
    )


def _shallow_breaks(nodes) -> bool:
    """break/continue belonging to THIS level (not to a nested loop)."""
    found = [False]

    def walk(n):
        if isinstance(n, (ast.For, ast.While)):
            return
        if isinstance(n, (ast.Break, ast.Continue)):
            found[0] = True
            return
        for c in ast.iter_child_nodes(n):
            walk(c)

    for n in nodes:
        walk(n)
    return found[0]


# ---------------------------------------------------------------------------
# pass 1: returns -> flag/value
# ---------------------------------------------------------------------------


def _has_nested_return(fdef: ast.FunctionDef) -> bool:
    """A Return anywhere below the function's top statement level."""
    for st in fdef.body:
        if isinstance(st, ast.Return):
            continue
        if _contains([st], ast.Return):
            return True
    return False


def _always_returns(block: List[ast.stmt]) -> bool:
    if not block:
        return False
    last = block[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return _always_returns(last.body) and _always_returns(last.orelse)
    return False


def _rewrite_returns(fdef: ast.FunctionDef):
    """Early returns -> continuation merging (ReturnTransformer analog).

    An `if` whose taken branch ALWAYS returns absorbs the statements that
    follow it into its other branch, so every path ends by assigning
    __ptt_ret_val__ — branch outputs stay structurally identical for the
    torch.cond lowering (no sentinel values that could not cross it). Ifs
    whose returning branch may fall through, and returns inside loops,
    are outside the subset (fall back)."""
    if not _has_nested_return(fdef):
        return
    for n in ast.walk(fdef):
        if isinstance(n, (ast.For, ast.While)) and _contains(
                n.body + n.orelse, ast.Return):
            raise _Unsupported("return inside a loop body")

    def rewrite_block(body: List[ast.stmt]) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for idx, st in enumerate(body):
            rest = body[idx + 1:]
            if isinstance(st, ast.Return):
                out.append(_loc(ast.Assign(
                    targets=[_name(_RET_VAL, ast.Store())],
                    value=st.value or _const(None),
                ), st))
                return out  # anything after a bare return is unreachable
            if not _contains([st], ast.Return):
                out.append(st)
                continue
            if not isinstance(st, ast.If):
                raise _Unsupported(f"return inside {type(st).__name__}")
            if _always_returns(st.body):
                new_if = ast.If(
                    test=st.test,
                    body=rewrite_block(st.body),
                    orelse=rewrite_block(list(st.orelse) + rest),
                )
            elif st.orelse and _always_returns(st.orelse):
                new_if = ast.If(
                    test=st.test,
                    body=rewrite_block(list(st.body) + rest),
                    orelse=rewrite_block(st.orelse),
                )
            else:
                raise _Unsupported(
                    "early return from an if branch that may fall through"
                )
            out.append(_loc(new_if, st))
            return out
        return out

    new_body = rewrite_block(fdef.body)
    prologue = ast.parse(f"{_RET_VAL} = None").body[0]
    final = ast.Return(value=_name(_RET_VAL))
    fdef.body = [_loc(prologue, fdef)] + new_body + [_loc(final, fdef)]


# ---------------------------------------------------------------------------
# pass 2: control flow + boolops
# ---------------------------------------------------------------------------


class _Converter(ast.NodeTransformer):
    def __init__(self):
        self._counter = 0

    def _uid(self, tag):
        self._counter += 1
        return f"__ptt_{tag}_{self._counter}__"

    def _uid_local(self, tag):
        """For-loop lowering locals (index/length/seq): single-underscore
        prefix so the carried-name analysis treats them as user state —
        the index MUST ride the converted while's carry."""
        self._counter += 1
        return f"_ptt_{tag}{self._counter}"

    # -- logical ops ---------------------------------------------------------
    def visit_BoolOp(self, node: ast.BoolOp):
        self.generic_visit(node)
        op = "__ptt_and__" if isinstance(node.op, ast.And) else "__ptt_or__"
        expr = node.values[0]
        for nxt in node.values[1:]:
            lam = ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=nxt,
            )
            expr = _call_rt(op, expr, lam)
        return _loc(expr, node)

    def visit_UnaryOp(self, node: ast.UnaryOp):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _loc(_call_rt("__ptt_not__", node.operand), node)
        return node

    def visit_Call(self, node: ast.Call):
        """foo(x) -> __ptt_call__(foo)(x): callees convert lazily at call
        time (convert_operators.py convert_call), so tensor control flow
        in UNDECORATED helper functions compiles too. Generated __ptt_*
        runtime calls and super() are left direct."""
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name) and (
            f.id.startswith("__ptt_") or f.id == "super"
        ):
            return node
        new = ast.Call(
            func=_call_rt("__ptt_call__", node.func),
            args=node.args, keywords=node.keywords,
        )
        return _loc(new, node)

    # nested defs/lambdas keep their own control flow un-converted (they
    # may run outside the capture; the reference converts callees lazily
    # at call time — out of this subset's scope)
    def visit_FunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    # -- shared pieces -------------------------------------------------------
    def _prelude(self, names, like):
        """try: __ptt_init_n__ = n / except NameError: ... = Undefined(n)"""
        stmts = []
        for n in names:
            stmts.append(_loc(ast.Try(
                body=[ast.Assign(
                    targets=[_name(f"__ptt_init_{n}__", ast.Store())],
                    value=_name(n),
                )],
                handlers=[ast.ExceptHandler(
                    type=ast.Tuple(
                        elts=[_name("NameError"),
                              _name("UnboundLocalError")],
                        ctx=ast.Load(),
                    ),
                    name=None,
                    body=[ast.Assign(
                        targets=[_name(f"__ptt_init_{n}__", ast.Store())],
                        value=_call_rt("__ptt_undef__", _const(n)),
                    )],
                )],
                orelse=[], finalbody=[],
            ), like))
        return stmts

    def _fn_def(self, fname, argnames, body, ret_names, like):
        ret = ast.Return(value=ast.Tuple(
            elts=[_name(n) for n in ret_names], ctx=ast.Load()
        ))
        fn = ast.FunctionDef(
            name=fname,
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=n) for n in argnames],
                kwonlyargs=[], kw_defaults=[], defaults=[],
            ),
            body=list(body) + [ret],
            decorator_list=[], returns=None,
        )
        return _loc(fn, like)

    def _unpack_assign(self, names, call, like):
        if names:
            target = ast.Tuple(
                elts=[_name(n, ast.Store()) for n in names],
                ctx=ast.Store(),
            )
        else:
            target = _name(self._uid("void"), ast.Store())
        return _loc(ast.Assign(targets=[target], value=call), like)

    # -- if ------------------------------------------------------------------
    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        if _shallow_breaks([node]):
            # break/continue belong to an enclosing loop; converting this
            # `if` into functions would orphan them
            return node
        names = _assigned_names(node.body + node.orelse)
        tname, fname = self._uid("true"), self._uid("false")
        tdef = self._fn_def(tname, names, node.body or [ast.Pass()],
                            names, node)
        fdef = self._fn_def(fname, names, node.orelse or [ast.Pass()],
                            names, node)
        init = ast.Tuple(
            elts=[_name(f"__ptt_init_{n}__") for n in names],
            ctx=ast.Load(),
        )
        call = _call_rt("__ptt_ifelse__", node.test, _name(tname),
                        _name(fname), init, _const(tuple(names)))
        assign = self._unpack_assign(names, call, node)
        return self._prelude(names, node) + [tdef, fdef, assign]

    # -- while ---------------------------------------------------------------
    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        return self._convert_while(node)

    def _convert_while(self, node: ast.While):
        if node.orelse:
            raise _Unsupported("while/else")
        if _shallow_breaks(node.body):
            return node  # python semantics; tensor preds error loudly
        names = _assigned_names(node.body)
        tname, bname = self._uid("test"), self._uid("body")
        tdef = self._fn_def(tname, names, [], [], node)
        tdef.body = [_loc(ast.Return(value=node.test), node)]
        bdef = self._fn_def(bname, names, node.body, names, node)
        init = ast.Tuple(
            elts=[_name(f"__ptt_init_{n}__") for n in names],
            ctx=ast.Load(),
        )
        call = _call_rt("__ptt_while__", _name(tname), _name(bname), init,
                        _const(tuple(names)))
        assign = self._unpack_assign(names, call, node)
        return self._prelude(names, node) + [tdef, bdef, assign]

    # -- for -> index while --------------------------------------------------
    def visit_For(self, node: ast.For):
        # `range(x)` detection must look at the ORIGINAL iter expression:
        # generic_visit wraps calls into __ptt_call__(range)(x), after
        # which the pattern would never match (and tensor bounds would
        # reach the python range() eagerly)
        is_range = (
            isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and len(node.iter.args) == 1
            and not node.iter.keywords
        )
        self.generic_visit(node)
        if node.orelse:
            raise _Unsupported("for/else")
        if _shallow_breaks(node.body):
            return node
        seq = self._uid_local("seq")
        n_ = self._uid_local("n")
        i_ = self._uid_local("i")
        # for TARGET in EXPR  ->  seq = EXPR; n = __ptt_len__(seq); i = 0
        #                         while i < n: TARGET = seq[i]; BODY; i += 1
        # `range(x)` iterates indices directly (no getitem).
        prologue = []
        if is_range:
            # after generic_visit the iter may be __ptt_call__(range)(x);
            # the bound expression is the (possibly transformed) sole arg
            prologue.append(_loc(ast.Assign(
                targets=[_name(n_, ast.Store())], value=node.iter.args[0]
            ), node))
            if isinstance(node.target, ast.Name):
                # the index is a while carry: it needs a pre-loop binding
                # for the tensor-bound (while_loop) case
                prologue.append(_loc(ast.Assign(
                    targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
                    value=_const(0),
                ), node))
            bind = [_loc(ast.Assign(targets=[node.target],
                                    value=_name(i_)), node)]
        else:
            prologue.append(_loc(ast.Assign(
                targets=[_name(seq, ast.Store())],
                value=_call_rt("__ptt_to_seq__", node.iter),
            ), node))
            prologue.append(_loc(ast.Assign(
                targets=[_name(n_, ast.Store())],
                value=_call_rt("__ptt_len__", _name(seq)),
            ), node))
            bind = [_loc(ast.Assign(
                targets=[node.target],
                value=_call_rt("__ptt_getitem__", _name(seq), _name(i_)),
            ), node)]
        prologue.append(_loc(ast.Assign(
            targets=[_name(i_, ast.Store())], value=_const(0)
        ), node))
        incr = _loc(ast.AugAssign(
            target=_name(i_, ast.Store()), op=ast.Add(), value=_const(1)
        ), node)
        loop = _loc(ast.While(
            test=ast.Compare(left=_name(i_), ops=[ast.Lt()],
                             comparators=[_name(n_)]),
            body=bind + list(node.body) + [incr],
            orelse=[],
        ), node)
        converted = self._convert_while(loop)
        if not isinstance(converted, list):
            converted = [converted]
        return prologue + converted


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


# transformed CODE objects, keyed by the original code object: one entry
# per source location (closure instances sharing code share the entry),
# None = conversion not possible. The FUNCTION is rebuilt per conversion
# request from the original's LIVE globals and closure cells, so a
# converted helper never computes with a stale snapshot.
_CODE_CACHE: dict = {}


def _transform_code(raw):
    """Compile `raw`'s rewritten source and extract the inner code object
    (the def is compiled nested inside a synthetic outer that declares
    the original free variables, so the inner code has real freevars —
    a top-level def could not). Never executed: only the code is taken,
    so nothing is exec'd into any namespace."""
    try:
        src = textwrap.dedent(inspect.getsource(raw))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return None
    if not _contains([fdef], (ast.If, ast.While, ast.For, ast.BoolOp,
                              ast.Call)):
        return None  # no control flow and no callees to convert
    if _contains([fdef], (ast.Global, ast.Nonlocal)):
        return None  # branch-fn extraction would shadow these bindings
    fdef.decorator_list = []
    # defaults are reused from the live function object, not re-evaluated
    fdef.args.defaults = []
    fdef.args.kw_defaults = [None] * len(fdef.args.kwonlyargs)
    try:
        _rewrite_returns(fdef)
        conv = _Converter()
        new_body = []
        for st in fdef.body:
            r = conv.visit(st)
            new_body.extend(r if isinstance(r, list) else [r])
        fdef.body = new_body
        ast.fix_missing_locations(fdef)
    except _Unsupported:
        return None
    freevars = list(raw.__code__.co_freevars)
    outer = ast.FunctionDef(
        name="__ptt_outer__",
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=v) for v in freevars],
            kwonlyargs=[], kw_defaults=[], defaults=[],
        ),
        body=[fdef, ast.Return(value=_name(fdef.name))],
        decorator_list=[], returns=None,
    )
    mod = ast.Module(body=[outer], type_ignores=[])
    ast.fix_missing_locations(mod)
    try:
        module_code = compile(
            mod,
            filename=f"<to_static {getattr(raw, '__qualname__', '?')}>",
            mode="exec",
        )
    except (SyntaxError, ValueError):
        return None
    import types

    for outer_code in module_code.co_consts:
        if isinstance(outer_code, types.CodeType) \
                and outer_code.co_name == "__ptt_outer__":
            for inner in outer_code.co_consts:
                if isinstance(inner, types.CodeType) \
                        and inner.co_name == fdef.name:
                    return inner
    return None


def convert_to_static(fn):
    """program_translator.py:756 convert_to_static. Returns the rewritten
    function (``fn2.__ptu_converted__ == True``) or `fn` unchanged when
    conversion is not possible.

    The rewritten function shares the ORIGINAL's ``__globals__`` dict and
    closure cells (types.FunctionType over the cached transformed code),
    so rebinding a module global or a closed-over variable is visible to
    the converted code exactly as it is to the eager original. The
    __ptt_* runtime helpers are installed into that globals dict under
    their reserved names."""
    import types

    raw = getattr(fn, "__func__", fn)
    if getattr(raw, "__ptu_converted__", False):
        return fn
    if getattr(raw, "__ptu_not_to_static__", False):
        return fn  # jit.not_to_static opt-out
    if not isinstance(raw, types.FunctionType):
        return fn
    if getattr(raw, "__wrapped__", None) is not None:
        # a decorated function (the package layers' forward behind
        # tensor_boundary): its source is the inner function's, its
        # globals the decorator's; rewriting it would drop the decorator
        return fn
    key = raw.__code__
    if key not in _CODE_CACHE:
        _CODE_CACHE[key] = _transform_code(raw)
    inner = _CODE_CACHE[key]
    if inner is None:
        return fn
    glb = raw.__globals__
    for k, v in _RT.items():
        glb.setdefault(k, v)
    cell_of = dict(zip(raw.__code__.co_freevars, raw.__closure__ or ()))
    try:
        closure = tuple(cell_of[v] for v in inner.co_freevars)
    except KeyError:
        return fn  # freevar set mismatch: fall back
    new_fn = types.FunctionType(
        inner, glb, raw.__name__, raw.__defaults__, closure or None
    )
    new_fn.__kwdefaults__ = raw.__kwdefaults__
    new_fn.__ptu_converted__ = True
    new_fn.__wrapped__ = raw
    inst = getattr(fn, "__self__", None)
    if inst is not None:
        new_fn = new_fn.__get__(inst, type(inst))
    return new_fn
