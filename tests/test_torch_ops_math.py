"""The port's op namespace against paddle_tpu's: binary elementwise math
and the rest of ``ops/math.py`` outside the unary, special and reduction
families (those have files of their own, which import :func:`check`).

Each case gives both packages the same numpy inputs (float32, seeded),
calls ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>`` with the same
arguments, and compares every output (float outputs within ``TOL``,
others exactly; the port's int64 against the JAX package's int32, which
runs without x64, by value). Then, unless a case says ``grad=False``,
both run ``backward()`` on ``sum(out * w)`` (``w`` seeded numpy) through
their own autograd and compare each float input's gradient within
``TOL``. JAX runs on the CPU, the port on CPU tensors
(``set_device("cpu")``).

Tolerances: float32 ``rtol = atol = 1e-5`` unless a case states its own
(sums and transcendental functions in different orders and libraries).
"""
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm

TOL = dict(rtol=1e-5, atol=1e-5)


def _fresh_process_state():
    """The global state a fresh worker process starts with, which other
    test files can leave changed: no hybrid mesh in either package (a
    left-over multi-device mesh shards the JAX package's parallel
    layers), and ``paddle_tpu.ops.pallas.flash_attention`` bound to the
    function (importing that submodule by name through the ``paddle``
    alias rebinds the package attribute to the module)."""
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """The port's default device is the CPU here (restored after); each
    module starts and ends in a fresh process's state."""
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    yield
    pt_device._current = saved
    _fresh_process_state()


def arr(shape, lo=-1.0, hi=1.0, seed=0, dtype=np.float32):
    """Seeded uniform [lo, hi) values of ``shape``."""
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)


def ints(shape, lo, hi, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape)


def _to(pkg, v, grad):
    if isinstance(v, np.ndarray):
        return pkg.to_tensor(v, stop_gradient=not (grad and v.dtype.kind
                                                   == "f"))
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(u, np.ndarray) for u in v):
        return [_to(pkg, u, grad) for u in v]
    return v


def _outs(out):
    if isinstance(out, (tuple, list)):
        return [o for o in out if hasattr(o, "_data")]
    return [out]


def _inputs(vals):
    for v in vals:
        for u in (v if isinstance(v, list) else [v]):
            if hasattr(u, "_data"):
                yield u


def _floating(a) -> bool:
    return a.dtype.kind in "fc"


def check(name, *args, grad=True, tol=TOL, **kwargs):
    """``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>`` on the same
    numpy ``args`` (the tensors) and ``kwargs``: outputs, then input
    gradients of ``sum(out * w)``."""
    jfn, tfn = getattr(paddle_tpu, name), getattr(pt, name)
    jargs = [_to(paddle_tpu, a, grad) for a in args]
    targs = [_to(pt, a, grad) for a in args]
    jout, tout = _outs(jfn(*jargs, **kwargs)), _outs(tfn(*targs, **kwargs))
    assert len(jout) == len(tout), name
    for j, t in zip(jout, tout):
        jv, tv = np.asarray(j._data), t.numpy()
        assert jv.shape == tv.shape, (name, jv.shape, tv.shape)
        if _floating(jv):
            np.testing.assert_allclose(tv, jv, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(tv.astype(jv.dtype), jv,
                                          err_msg=name)
    if not grad:
        return
    r = np.random.RandomState(1)
    terms = []
    for j, t in zip(jout, tout):
        jv = np.asarray(j._data)
        if jv.dtype.kind != "f" or t.stop_gradient:
            continue
        w = r.uniform(0.5, 1.5, jv.shape).astype(jv.dtype)
        terms.append((paddle_tpu.sum(j * paddle_tpu.to_tensor(w)),
                      pt.sum(t * pt.to_tensor(w))))
    assert terms, f"{name}: no differentiable output"
    jl, tl = terms[0]
    for a, b in terms[1:]:
        jl, tl = jl + a, tl + b
    jl.backward()
    tl.backward()
    for jx, tx in zip(_inputs(jargs), _inputs(targs)):
        # no gradient (None) and a gradient of zeros are one answer
        jg, tg = jx.gradient(), tx.gradient()
        shape = np.shape(np.asarray(jx._data))
        jg = np.zeros(shape) if jg is None else jg
        tg = np.zeros(shape) if tg is None else tg
        np.testing.assert_allclose(tg, jg, err_msg=f"{name} grad", **tol)


X = arr((3, 4))
Y = arr((3, 4), seed=1)
POS = arr((3, 4), 0.5, 2.0, seed=2)

BINARY = [
    ("add", (X, Y)), ("subtract", (X, Y)), ("multiply", (X, Y)),
    ("divide", (X, POS)), ("floor_divide", (X * 5, POS)),
    ("mod", (X * 5, POS)), ("remainder", (X * 5, POS)),
    ("floor_mod", (X * 5, POS)), ("pow", (POS, Y)),
    ("maximum", (X, Y)), ("minimum", (X, Y)), ("fmax", (X, Y)),
    ("fmin", (X, Y)), ("atan2", (X, Y)), ("hypot", (X, Y)),
    ("logaddexp", (X, Y)), ("heaviside", (X, Y)), ("copysign", (X, Y)),
]
# no gradient through these (integer or discrete results)
BINARY_NOGRAD = [
    ("nextafter", (X, Y)), ("gcd", (ints((3, 4), 1, 40), ints((3, 4), 1, 40,
                                                             1))),
    ("lcm", (ints((3, 4), 1, 20), ints((3, 4), 1, 20, 1))),
    ("ldexp", (X, ints((3, 4), -3, 4))),
]


@pytest.mark.parametrize("name,args", BINARY, ids=[c[0] for c in BINARY])
def test_binary(name, args):
    check(name, *args, grad=name not in ("floor_divide",))


@pytest.mark.parametrize("name,args", BINARY_NOGRAD,
                         ids=[c[0] for c in BINARY_NOGRAD])
def test_binary_no_grad(name, args):
    check(name, *args, grad=False)


def test_binary_with_scalars_keeps_the_tensor_type():
    """A Python scalar on either side keeps the tensor's type (float16
    stays float16), as the JAX package's weak types do."""
    x = X.astype(np.float16)
    for pkg in (paddle_tpu, pt):
        t = pkg.to_tensor(x)
        for out in (t + 2.0, 2.0 * t, t / 3, 1 - t, t ** 2):
            assert "float16" in str(out.dtype)
    check("add", X, 2.5)
    check("pow", POS, 3)


MISC = [
    ("scale", (X,), dict(scale=2.0, bias=1.0)),
    ("scale", (X,), dict(scale=2.0, bias=1.0, bias_after_scale=False)),
    ("clip", (X,), dict(min=-0.3, max=0.4)),
    ("lerp", (X, Y, 0.3), {}),
    ("lerp", (X, Y, POS), {}),
    ("stanh", (X,), {}),
    ("kron", (arr((2, 3)), arr((3, 2), seed=1)), {}),
    ("inner", (X, Y), {}),
    ("outer", (arr((4,)), arr((5,), seed=1)), {}),
    ("diff", (X,), dict(axis=1)),
    ("diff", (X,), dict(n=2, axis=0)),
]


@pytest.mark.parametrize("name,args,kw", MISC,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(MISC)])
def test_misc(name, args, kw):
    check(name, *args, **kw)


def test_multiplex_and_increment():
    a, b = arr((4, 3)), arr((4, 3), seed=1)
    idx = np.array([[0], [1], [1], [0]], np.int32)
    check("multiplex", [a, b], idx)
    for pkg in (paddle_tpu, pt):
        t = pkg.to_tensor(np.array([1.0], np.float32))
        assert pkg.increment(t, 2.0) is t
        np.testing.assert_allclose(np.asarray(t.numpy()), [3.0])


def test_exponential_fills_in_place_with_draws():
    """Paddle's ``exponential_`` (the JAX package computes ``exp``
    here): the tensor is refilled with Exponential(lam) draws from the
    package's generator, reproducible under ``seed``."""
    x = pt.zeros([20000])
    pt.seed(3)
    assert pt.exponential_(x, lam=2.0) is x
    v = x.numpy()
    assert (v >= 0).all() and abs(v.mean() - 0.5) < 0.02
    y = pt.zeros([20000])
    pt.seed(3)
    np.testing.assert_array_equal(pt.exponential_(y, lam=2.0).numpy(), v)
