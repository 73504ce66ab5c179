"""The dygraph-to-static AST conversion of the port (``jit/ast_transform``,
``jit/convert_ops``) against the JAX package's, on the CPU.

The cases of ``tests/test_dygraph_to_static.py``: each function (the
reference's text, with ``paddle`` the port) runs eagerly and through
``to_static`` in the port, and its JAX twin (that file's function)
through the JAX package's ``to_static``, on the same numpy inputs; the
three agree (rtol 1e-5, atol 1e-6), and the port's converted path is the
AST rewrite (``__ptu_converted__``), not a fallback. A tensor condition
is captured as torch's ``cond`` / ``while_loop`` ops. Then
``jit.not_to_static``.
"""
import numpy as np
import pytest

import paddle_tpu
import test_dygraph_to_static as ref

import paddle_tpu_torch as paddle
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.jit.ast_transform import convert_to_static
from test_torch_ops_math import cpu_device  # noqa: F401


# -- the reference's function bodies, on the port ---------------------------


def dyfunc_with_if_else(x_v):
    if x_v.mean() > 0.5:
        x_v = x_v - 1
    else:
        x_v = x_v + 1
    return x_v


def dyfunc_with_if_else_early_return(x):
    if x.mean() > 0.5:
        return x * 2
    return x - 2


def dyfunc_nested_if(x):
    y = x + 1
    if x.mean() > 0:
        if x.sum() > 10:
            y = y * 2
        else:
            y = y * 3
    else:
        y = y - 1
    return y


def dyfunc_undefined_then_assigned(x):
    if x.mean() > 0.5:
        y = x + 10
    else:
        y = x - 10
    return y


def dyfunc_boolops(x):
    if (x.mean() > 0.1) and (x.sum() < 100) or False:
        return x + 1
    return x - 1


def dyfunc_while(x):
    i = paddle.to_tensor(np.float32(0))
    s = paddle.to_tensor(np.float32(0))
    while i < 10:
        s = s + i
        i = i + 1
    return s + x.mean() * 0


def dyfunc_for_range_tensor_body(x):
    s = paddle.zeros([4])
    for i in range(3):
        s = s + x
    return s


def dyfunc_for_over_tensor(xs):
    s = paddle.zeros([4])
    for row in xs:
        s = s + row
    return s


def _check(fn, ref_fn, *arrays, rtol=1e-5):
    eager = fn(*[paddle.to_tensor(a) for a in arrays]).numpy()
    static_fn = to_static(fn)
    out = static_fn(*[paddle.to_tensor(a) for a in arrays]).numpy()
    want = np.asarray(paddle_tpu.jit.to_static(ref_fn)(
        *[paddle_tpu.to_tensor(a) for a in arrays]).numpy())
    np.testing.assert_allclose(out, eager, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(out, want, rtol=rtol, atol=1e-6)
    # the converted path must actually be the AST rewrite, not a fallback
    assert getattr(static_fn._fn, "__ptu_converted__", False)
    return static_fn


def _captured_ops(static_fn):
    (prog,) = static_fn.program_cache.values()
    return {getattr(n.target, "__name__", str(n.target))
            for n in prog.exported.graph.nodes}


class TestIfElse:
    def test_simple_if_else_both_sides(self):
        for v in (0.9, 0.1):
            sf = _check(dyfunc_with_if_else, ref.dyfunc_with_if_else,
                        np.full((4,), v, np.float32))
            assert "cond" in _captured_ops(sf)

    def test_early_return(self):
        for v in (0.9, 0.1):
            _check(dyfunc_with_if_else_early_return,
                   ref.dyfunc_with_if_else_early_return,
                   np.full((4,), v, np.float32))

    def test_nested_if(self):
        for v in (5.0, 1.0, -1.0):
            _check(dyfunc_nested_if, ref.dyfunc_nested_if,
                   np.full((4,), v, np.float32))

    def test_var_defined_only_inside_branches(self):
        for v in (0.9, 0.1):
            _check(dyfunc_undefined_then_assigned,
                   ref.dyfunc_undefined_then_assigned,
                   np.full((4,), v, np.float32))

    def test_bool_ops_on_tensors(self):
        for v in (0.5, 0.0):
            _check(dyfunc_boolops, ref.dyfunc_boolops,
                   np.full((4,), v, np.float32))

    def test_python_condition_keeps_python_semantics(self):
        flag = True

        def f(x):
            if flag:
                return x + 1
            return x - 1

        sf = _check(f, f, np.ones((3,), np.float32))
        assert "cond" not in _captured_ops(sf)


class TestLoops:
    def test_while_over_tensor(self):
        sf = _check(dyfunc_while, ref.dyfunc_while, np.ones((4,), np.float32))
        assert "while_loop" in _captured_ops(sf)

    def test_for_range(self):
        _check(dyfunc_for_range_tensor_body, ref.dyfunc_for_range_tensor_body,
               np.ones((4,), np.float32))

    def test_for_over_tensor_rows(self):
        _check(dyfunc_for_over_tensor, ref.dyfunc_for_over_tensor,
               np.arange(12, dtype=np.float32).reshape(3, 4))

    def test_uninitialized_while_var_raises(self):
        def f(x):
            while x.mean() < 5:
                y = x * 2  # noqa: F841 — assigned only inside the body
                x = x + y
            return x

        static_fn = to_static(f)
        with pytest.raises(TypeError, match="'y'"):
            static_fn(paddle.to_tensor(np.ones((2,), np.float32)))


class TestLayerIntegration:
    def test_layer_forward_with_tensor_if(self):
        def make(pkg):
            class Net(pkg.nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.fc = pkg.nn.Linear(4, 4)

                def forward(self, x):
                    h = self.fc(x)
                    if h.mean() > 0:
                        h = h * 2
                    else:
                        h = h - 1
                    return h

            return Net()

        paddle_tpu.seed(7)
        jnet = make(paddle_tpu)
        net = make(paddle)
        net.set_state_dict({k: np.asarray(v.numpy())
                            for k, v in jnet.state_dict().items()})
        x = np.ones((2, 4), np.float32)
        eager = net(paddle.to_tensor(x)).numpy()
        want = np.asarray(paddle_tpu.jit.to_static(jnet)(
            paddle_tpu.to_tensor(x)).numpy())
        out = to_static(net)(paddle.to_tensor(x)).numpy()
        np.testing.assert_allclose(out, eager, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)

    def test_grad_flows_through_converted_if(self):
        def f(x):
            if x.sum() > 0:
                y = x * 3
            else:
                y = x * 5
            return y.sum()

        conv = convert_to_static(f)
        assert conv.__ptu_converted__
        x = paddle.to_tensor(np.ones((3,), np.float32))
        x.stop_gradient = False
        conv(x).backward()
        np.testing.assert_allclose(x.grad.numpy(), np.full((3,), 3.0),
                                   rtol=1e-6)
        # and through the captured cond op, both branches
        for sign, g in ((1.0, 3.0), (-1.0, 5.0)):
            x = paddle.to_tensor(np.full((3,), sign, np.float32))
            x.stop_gradient = False
            to_static(f)(x).backward()
            np.testing.assert_allclose(x.grad.numpy(), np.full((3,), g),
                                       rtol=1e-6)


class TestFallbacks:
    def test_break_keeps_python_loop(self):
        def f(x):
            s = x * 0
            for i in range(4):
                if i == 2:
                    break
                s = s + x
            return s

        static_fn = to_static(f)
        out = static_fn(paddle.to_tensor(np.ones((2,), np.float32)))
        np.testing.assert_allclose(out.numpy(), np.full((2,), 2.0))

    def test_unconvertible_source_falls_back(self):
        # builtins have no source: conversion must not explode
        assert convert_to_static(len) is len


class TestConvertCall:
    def test_undecorated_helper_with_tensor_if_converts(self):
        def helper(v):
            if v.mean() > 0.5:
                return v * 2
            return v - 2

        def outer(x):
            y = helper(x) + 1
            return y

        sf = to_static(outer)
        for fill in (0.9, 0.1):
            arr = np.full((4,), fill, np.float32)
            got = sf(paddle.to_tensor(arr)).numpy()
            want = (arr * 2 + 1) if fill > 0.5 else (arr - 2 + 1)
            np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_library_calls_pass_through(self):
        def outer(x):
            s = len(x.shape) + max(1, 2)  # builtins untouched
            return paddle.abs(x) * s     # framework fns untouched

        sf = to_static(outer)
        arr = np.array([-1.0, 2.0], np.float32)
        np.testing.assert_allclose(
            sf(paddle.to_tensor(arr)).numpy(), np.abs(arr) * 3, rtol=1e-6)


SCALE = 2.0


def _scaled_helper(v):
    if v.mean() > -1e9:       # tensor condition: forces conversion
        return paddle.abs(v) * SCALE
    return v


class TestConvertCallScoping:
    """Converted callees see LIVE module globals and closure cells."""

    def test_rebinding_module_global_is_visible(self):
        global SCALE

        def outer(x):
            return _scaled_helper(x) + 0

        sf = to_static(outer)
        SCALE = 2.0
        a = sf(paddle.to_tensor(np.ones((2,), np.float32))).numpy()
        np.testing.assert_allclose(a, 2.0)
        SCALE = 10.0
        try:
            # new shape -> new capture; the helper must read the NEW global
            b = sf(paddle.to_tensor(np.ones((3,), np.float32))).numpy()
            np.testing.assert_allclose(b, 10.0)
        finally:
            SCALE = 2.0

    def test_closure_cells_stay_live(self):
        def make():
            k = paddle.to_tensor(np.float32(3.0))

            def helper(v):
                if v.mean() > -1e9:
                    return v * k
                return v

            def rebind(new):
                nonlocal k
                k = new

            return helper, rebind

        helper, rebind = make()

        def outer(x):
            return helper(x) + 0

        sf = to_static(outer)
        a = sf(paddle.to_tensor(np.ones((2,), np.float32))).numpy()
        np.testing.assert_allclose(a, 3.0)
        rebind(paddle.to_tensor(np.float32(7.0)))
        b = sf(paddle.to_tensor(np.ones((3,), np.float32))).numpy()
        np.testing.assert_allclose(b, 7.0)

    def test_not_to_static_opt_out(self):
        from paddle_tpu_torch.jit import not_to_static
        from paddle_tpu_torch.jit.convert_ops import convert_call

        @not_to_static
        def keep_eager(v):
            return v + 1

        assert convert_call(keep_eager) is keep_eager
        assert convert_to_static(keep_eager) is keep_eager

    def test_for_range_tensor_bound(self):
        """A TENSOR trip count lowers to a converted while."""

        def f(x):
            n = (x.sum() * 0 + 3).astype("int32")
            s = x * 0
            for _i in range(n):
                s = s + x
            return s

        sf = to_static(f)
        out = sf(paddle.to_tensor(np.ones((2,), np.float32))).numpy()
        np.testing.assert_allclose(out, 3.0)

    def test_default_args_reused_not_reevaluated(self):
        def f(x, k=2.0):
            if x.mean() > -1e9:
                return x * k
            return x

        conv = convert_to_static(f)
        assert conv.__ptu_converted__
        np.testing.assert_allclose(
            conv(paddle.to_tensor(np.ones((2,), np.float32))).numpy(), 2.0)
        np.testing.assert_allclose(
            conv(paddle.to_tensor(np.ones((2,), np.float32)), k=5.0
                 ).numpy(), 5.0)


def test_not_to_static_helper_keeps_its_python_if():
    """A ``not_to_static`` helper's Python ``if`` on a tensor is not
    rewritten: inside a capture it is a data-dependent branch, and
    ``to_static`` raises naming the function; unmarked, the same helper
    is converted and captured."""
    from paddle_tpu_torch.jit import not_to_static

    def helper(v):
        if v.mean() > 0:
            return v * 2
        return v

    def outer(x):
        return helper(x) + 1

    x = np.ones((2,), np.float32)
    np.testing.assert_allclose(to_static(outer)(paddle.to_tensor(x)).numpy(),
                               3.0)
    not_to_static(helper)
    with pytest.raises(RuntimeError, match="could not capture outer"):
        to_static(outer)(paddle.to_tensor(x))
    assert paddle.jit.not_to_static is not_to_static
