"""The port's ``Tensor`` and autograd against paddle_tpu's, on the
scenarios of ``tests/test_tensor.py`` and ``tests/test_autograd.py``.

Each scenario is one function of a package (``paddle_tpu`` or
``paddle_tpu_torch``, imported as ``paddle``) that returns what it
observed: numpy values, gradients, shapes, type names, flags. Both
packages run it and the observations must agree (floats within rtol =
atol = 1e-6; everything else exactly). Where a scenario expects an error,
both must raise the same type. Integer types compare by kind: the port
keeps int64 where the JAX package, without x64, has int32.

Beyond the reference: ``paddle.grad(create_graph=True)`` (the JAX
package's eager tape refuses it) is checked against the analytic second
derivative.
"""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.autograd import NanInfError
from paddle_tpu_torch.core.dtype import dtype_name
from test_torch_ops_math import cpu_device  # noqa: F401


def _name(paddle, t):
    d = t.dtype
    name = dtype_name(d) if paddle is pt else str(d)
    return {"int32": "int", "int64": "int"}.get(name, name)


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def s_to_tensor_and_dtypes(paddle):
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    return dict(shape=x.shape, dtype=_name(paddle, x), value=_np(x),
                i=_name(paddle, paddle.to_tensor(1)),
                f=_name(paddle, paddle.to_tensor(1.0)),
                b=_name(paddle, paddle.to_tensor(True)),
                f64=_name(paddle, paddle.to_tensor(np.zeros(2))),
                i32=_name(paddle, paddle.to_tensor([1, 2], dtype="int32")),
                ndim=x.ndim, size=x.size, len=len(x),
                item=paddle.to_tensor(3.5).item(),
                astype=_name(paddle, x.astype("int32")),
                cast=_np(paddle.cast(x * 1.6, "int32")))


def s_arithmetic_and_comparison(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0])
    y = paddle.to_tensor([4.0, 5.0, 6.0])
    return dict(add=_np(x + y), sub=_np(x - y), mul=_np(x * y),
                div=_np(y / x), radd=_np(1 + x), rsub=_np(1 - x),
                pow=_np(x ** 2), rpow=_np(2 ** x), neg=_np(-x),
                floordiv=_np(y // x), mod=_np(y % x), matmul=_np(x @ y),
                gt=_np(x > 2), le=_np(x <= y), eq=_np(x == 2.0),
                ne=_np(x != 2.0), invert=_np(~(x > 2)),
                logic=_np(paddle.logical_and(x > 1, x < 3)),
                allclose=bool(paddle.allclose(x, x)),
                keeps=_name(paddle, x + 2.0), abs=_np(abs(-x)))


def s_indexing_and_setitem(paddle):
    x = paddle.to_tensor(np.arange(12.0, dtype=np.float32).reshape(3, 4))
    out = dict(row=_np(x[1]), col=_np(x[:, 1]), block=_np(x[1:, 2:]),
               fancy=_np(x[paddle.to_tensor([2, 0])]),
               mask=_np(x[x > 6.0]), neg=_np(x[-1, ::2]))
    x[0, 0] = 99.0
    x[1] = paddle.to_tensor([7.0, 7.0, 7.0, 7.0])
    x[2, 1:3] = 5.0
    out["after"] = _np(x)
    out["rows"] = [_np(r) for r in x]
    return out


def s_set_value_detach_clone(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    d = x.detach()
    x.set_value(np.array([5.0, 6.0], np.float32))
    c = x.clone()
    try:
        x.set_value(np.zeros((3,), np.float32))
        raised = None
    except Exception as e:  # noqa: BLE001 - the type is the observation
        raised = type(e).__name__
    return dict(d_sg=d.stop_gradient, value=_np(x), clone=_np(c),
                x_sg=x.stop_gradient, raised=raised,
                clone_sg=c.stop_gradient)


def s_numpy_left_operand(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    r = np.array([1.0, 2.0], np.float32) + x
    r2 = np.float32(2.0) * x
    paddle.sum(r * r2).backward()
    return dict(is_tensor=isinstance(r, type(x)) and isinstance(r2, type(x)),
                grad=x.gradient())


def s_simple_and_chain(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    z = paddle.sum((x * 3.0 + 1.0) * (x * 3.0 + 1.0))
    z.backward()
    g1 = x.gradient()
    paddle.sum(x * 2.0).backward()  # accumulates
    g2 = x.gradient()
    x.clear_grad()
    return dict(g1=g1, g2=g2, cleared=x.gradient())


def s_shared_input_and_broadcast(paddle):
    x = paddle.to_tensor([2.0], stop_gradient=False)
    (x * x + x * 3.0).backward()
    a = paddle.to_tensor(np.ones((3, 4), np.float32), stop_gradient=False)
    b = paddle.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
    paddle.sum(a + b).backward()
    return dict(shared=x.gradient(), bcast=b.gradient())


def s_stop_gradient_and_detach(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.to_tensor([2.0])
    paddle.sum(x * y).backward()
    w = paddle.to_tensor([1.0], stop_gradient=False)
    paddle.sum((w * 2.0).detach() * 3.0).backward()  # no graph: a no-op
    v = paddle.to_tensor([1.0], stop_gradient=False)
    u = v * 2.0
    u.stop_gradient = True
    return dict(x=x.gradient(), y=y.grad is None, y_sg=y.stop_gradient,
                w=w.grad is None, u_sg=u.stop_gradient)


def s_no_grad_and_modes(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2.0
    y2 = x * 2.0
    prev = paddle.set_grad_enabled(False)
    off = paddle.is_grad_enabled()
    z = x * 3.0
    paddle.set_grad_enabled(prev)
    with paddle.no_grad():
        with paddle.enable_grad():
            e = x * 4.0
    return dict(y=y.stop_gradient, y2=y2.stop_gradient, prev=prev, off=off,
                z=z.stop_gradient, e=e.stop_gradient,
                on=paddle.is_grad_enabled())


def s_matmul_and_unary_grads(paddle):
    r = np.random.RandomState(0)
    a = paddle.to_tensor(r.rand(3, 4).astype(np.float32), stop_gradient=False)
    b = paddle.to_tensor(r.rand(4, 2).astype(np.float32), stop_gradient=False)
    paddle.sum(paddle.matmul(a, b)).backward()
    x = paddle.to_tensor(np.array([0.5, 1.0, 1.5], np.float32),
                         stop_gradient=False)
    paddle.sum(paddle.exp(x) + paddle.log(x) + paddle.sqrt(x)
               + paddle.tanh(x) + paddle.sigmoid(x)).backward()
    return dict(a=a.gradient(), b=b.gradient(), x=x.gradient())


def s_multi_output_and_int_inputs(paddle):
    x = paddle.to_tensor(np.arange(6.0, dtype=np.float32),
                         stop_gradient=False)
    p = paddle.split(x, 2)
    (paddle.sum(p[0] * 2.0) + paddle.sum(p[1] * 3.0)).backward()
    y = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    paddle.sum(paddle.gather(y, paddle.to_tensor([0, 2], dtype="int32"))
               ).backward()
    return dict(split=x.gradient(), gather=y.gradient())


def s_paddle_grad(paddle):
    x = paddle.to_tensor([3.0], stop_gradient=False)
    (gx,) = paddle.grad(x * x, x)
    z = paddle.to_tensor([1.0], stop_gradient=False)
    w = paddle.to_tensor([1.0], stop_gradient=False)
    y = w * 2.0
    try:
        paddle.grad(y, [z], retain_graph=True)
        unused = None
    except RuntimeError:
        unused = "RuntimeError"
    gw, gz = paddle.grad(y, [w, z], allow_unused=True)
    try:
        paddle.grad([x * 2.0, x * 3.0], [x], grad_outputs=[paddle.ones([1])])
        mismatch = None
    except ValueError:
        mismatch = "ValueError"
    return dict(gx=_np(gx), untouched=x.grad is None, unused=unused,
                gw=_np(gw), gz=gz is None, gx_sg=gx.stop_gradient,
                mismatch=mismatch)


def s_retain_graph(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.sum(x * x)
    y.backward()
    try:
        y.backward()
        second = None
    except RuntimeError:
        second = "RuntimeError"
    v = paddle.to_tensor([1.0], stop_gradient=False)
    w = paddle.sum(v * v)
    w.backward(retain_graph=True)
    w.backward()
    return dict(second=second, retained=v.gradient())


def s_hooks(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    seen = []

    def hook(g):
        seen.append(_np(g).copy())
        return g * 2.0

    x.register_hook(hook)
    paddle.sum(x * 3.0).backward()
    y = paddle.to_tensor([2.0], stop_gradient=False)
    once = []
    y.register_hook(lambda g: once.append(_np(g).copy()))
    (y * y + y * 3.0).backward()
    return dict(seen=seen, x=x.gradient(), once=once)


def s_nonscalar_and_deep_chain(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 2.0).backward()
    y = paddle.to_tensor([1.0], stop_gradient=False)
    h = y
    for _ in range(2000):
        h = h + 0.001
    paddle.sum(h).backward()
    s = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (s * 3.0).backward(paddle.to_tensor([1.0, 10.0]))
    return dict(x=x.gradient(), deep=y.gradient(), seeded=s.gradient())


def s_inplace(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 2.0
    y.add_(1.0)
    y.scale_(3.0)
    paddle.sum(y).backward()
    leaf = paddle.to_tensor([1.0], stop_gradient=False)
    try:
        leaf.add_(1.0)
        raised = None
    except RuntimeError:
        raised = "RuntimeError"
    with paddle.no_grad():
        leaf.add_(1.0)
    z = paddle.to_tensor([4.0, 9.0])
    z.sqrt_()
    z.zero_()
    f = paddle.to_tensor([1.0, 2.0])
    f.fill_(3.0)
    r = paddle.to_tensor(np.arange(6.0, dtype=np.float32))
    r.reshape_([2, 3])
    return dict(x=x.gradient(), raised=raised, leaf=_np(leaf),
                leaf_sg=leaf.stop_gradient, z=_np(z), f=_np(f),
                r=r.shape, y=_np(y))


def s_setitem_grads(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2.0
    y[0] = 100.0
    paddle.sum(y).backward()
    a = paddle.to_tensor([1.0, 2.0])
    v = paddle.to_tensor([5.0], stop_gradient=False)
    b = a + 0.0
    b[0] = v * 3.0
    paddle.sum(b).backward()
    leaf = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    try:
        leaf[0] = 3.0
        raised = None
    except RuntimeError:
        raised = "RuntimeError"
    return dict(x=x.gradient(), v=v.gradient(), y=_np(y), b=_np(b),
                raised=raised)


def s_methods(paddle):
    x = paddle.to_tensor(np.arange(6.0, dtype=np.float32).reshape(2, 3))
    return dict(sum=_np(x.sum(axis=1)), mean=_np(x.mean()),
                max=_np(x.max(axis=0)), reshape=x.reshape([3, 2]).shape,
                transpose=x.transpose([1, 0]).shape,
                unsqueeze=x.unsqueeze(0).shape, flatten=x.flatten().shape,
                split=[t.shape for t in x.split(3, axis=1)],
                argmax=_np(x.argmax(axis=1)), topk=_np(x.topk(2)[0]),
                clip=_np(x.clip(1.0, 4.0)), pow=_np(x.pow(2)),
                matmul=_np(x.matmul(x, transpose_y=True)),
                tril=_np(x.tril()), where=_np(x.where(x > 2, x * 0)),
                equal=_np(x.equal(x)), expand=x[0:1].expand([4, 3]).shape,
                gather=_np(x.gather(paddle.to_tensor([1]))))


SCENARIOS = [s_to_tensor_and_dtypes, s_arithmetic_and_comparison,
             s_indexing_and_setitem, s_set_value_detach_clone,
             s_numpy_left_operand, s_simple_and_chain,
             s_shared_input_and_broadcast, s_stop_gradient_and_detach,
             s_no_grad_and_modes, s_matmul_and_unary_grads,
             s_multi_output_and_int_inputs, s_paddle_grad, s_retain_graph,
             s_hooks, s_nonscalar_and_deep_chain, s_inplace, s_setitem_grads,
             s_methods]


def _agree(got, want, path="") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _agree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        w, g = np.asarray(want), np.asarray(got)
        assert g.shape == w.shape, path
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), path
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[2:] for f in SCENARIOS])
def test_scenario_matches_paddle_tpu(scenario):
    _agree(scenario(pt), scenario(paddle_tpu))


def test_grad_create_graph_gives_second_derivatives():
    """Beyond the reference (its tape refuses ``create_graph``):
    d2/dx2 of x**3 is 6x."""
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    (g,) = pt.grad(pt.sum(x ** 3), x, create_graph=True)
    assert not g.stop_gradient
    np.testing.assert_allclose(g.numpy(), [3.0, 12.0])
    (g2,) = pt.grad(pt.sum(g), x)
    np.testing.assert_allclose(g2.numpy(), [6.0, 12.0])


def test_check_nan_inf_names_the_op_in_both_phases():
    """``FLAGS_check_nan_inf``: a forward output and an op's gradient for
    its inputs, each naming the op and the phase, as in the JAX
    package. A flag of the JAX package that the port does not act on is
    unknown to the port."""
    from paddle_tpu.core.autograd import NanInfError as JaxNanInfError

    for paddle, err in ((paddle_tpu, JaxNanInfError), (pt, NanInfError)):
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        try:
            assert paddle.get_flags("FLAGS_check_nan_inf") == {
                "FLAGS_check_nan_inf": True}
            with pytest.raises(err, match="op 'log'") as fwd:
                paddle.log(paddle.to_tensor(np.array([1.0, -1.0],
                                                     np.float32)))
            assert fwd.value.phase == "forward"
            t = paddle.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
            out = paddle.sqrt(t)
            with pytest.raises(err, match="grad of op 'sqrt'") as bwd:
                out.sum().backward()
            assert bwd.value.op_name == "sqrt"
            assert bwd.value.phase == "backward"
        finally:
            paddle.set_flags({"FLAGS_check_nan_inf": False})
        assert np.isnan(np.asarray(paddle.log(paddle.to_tensor(
            np.array([-1.0], np.float32))).numpy())).all()
        with pytest.raises(KeyError):
            paddle.set_flags({"FLAGS_no_such_flag": 1})
    # a flag the port does not act on is not registered: setting it raises
    with pytest.raises(KeyError):
        pt.set_flags({"FLAGS_use_bf16_matmul": False})
