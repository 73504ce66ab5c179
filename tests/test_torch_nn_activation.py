"""The port's activation functionals and layers against paddle_tpu's, and
the parity helpers the other ``test_torch_nn_*`` files import.

Each case gives both packages the same seeded numpy inputs (float32),
calls ``paddle_tpu.nn.functional.<name>`` (or the layer) and the port's
with the same arguments, and compares every output: float outputs within
rtol 1e-5 / atol 1e-6 (or, with ``rel``, within ``rel`` of the largest
output), others by value (the port's int64 against the JAX package's
int32). Then both run ``backward()`` on ``sum(out * w)`` (``w`` seeded)
and compare each float input's gradient within 1e-5 of its largest value
(and, for a layer, each parameter's). Layers carry the reference's
weights by ``set_state_dict`` of its numpy state dict. JAX runs on the
CPU, the port on CPU tensors (``set_device("cpu")``).

Random names (``gumbel_softmax``) are held by shape, the ``hard``
one-hot and the row sums, not by value.
"""
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from test_torch_ops_math import _outs, _to, arr, cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
#: a gradient within GRAD_REL of its largest value
GRAD_REL = 1e-5


def _near(got, want, rel, what):
    if rel is None:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)
        return
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, f"{what}: max |err| {err:.3e}, largest " \
        f"{scale:.3e}"


def compare(jfn, tfn, args, kw=None, tkw=None, grad=True, rel=None,
            params=()):
    """``jfn(*args, **kw)`` against ``tfn(*args, **(tkw or kw))`` on the
    numpy ``args`` as each package's tensors: outputs, then the
    gradients of ``sum(out * w)`` for the float inputs and ``params``
    (pairs of a reference and a port parameter). Returns both outputs."""
    kw = kw or {}
    jargs = [_to(paddle_tpu, a, grad) for a in args]
    targs = [_to(pt, a, grad) for a in args]
    jout = _outs(jfn(*jargs, **kw))
    tout = _outs(tfn(*targs, **(kw if tkw is None else tkw)))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        jv, tv = np.asarray(j._data), t.numpy()
        assert jv.shape == tv.shape, (jv.shape, tv.shape)
        if jv.dtype.kind == "f":
            _near(tv, jv, rel, "output")
        else:
            np.testing.assert_array_equal(tv.astype(jv.dtype), jv)
    if not grad:
        return jout, tout
    r = np.random.RandomState(1)
    jl = tl = None
    for j, t in zip(jout, tout):
        jv = np.asarray(j._data)
        if jv.dtype.kind != "f" or t.stop_gradient:
            continue
        w = r.uniform(0.5, 1.5, jv.shape).astype(jv.dtype)
        a = paddle_tpu.sum(j * paddle_tpu.to_tensor(w))
        b = pt.sum(t * pt.to_tensor(w))
        jl, tl = (a, b) if jl is None else (jl + a, tl + b)
    jl.backward()
    tl.backward()
    pairs = [(jx, tx) for jx, tx in zip(jargs, targs)
             if hasattr(jx, "_data") and not tx.stop_gradient]
    for jx, tx in pairs + list(params):
        jg, tg = jx.gradient(), tx.gradient()
        shape = np.shape(np.asarray(jx._data))
        jg = np.zeros(shape) if jg is None else np.asarray(jg)
        tg = np.zeros(shape) if tg is None else np.asarray(tg)
        _near(tg, jg, GRAD_REL, "gradient")
    return jout, tout


def carry(jlayer, tlayer):
    """The reference layer's numpy state dict into the port's layer;
    returns the (reference, port) parameter pairs by name."""
    state = {k: np.asarray(v._data) for k, v in jlayer.state_dict().items()}
    assert tlayer.set_state_dict(state) == ([], [])
    tparams = dict(tlayer.named_parameters())
    return [(p, tparams[n]) for n, p in jlayer.named_parameters()
            if not p.stop_gradient]


def compare_layers(jlayer, tlayer, args, grad=True, rel=None, **kw):
    """Two layers on carried weights: outputs, input and parameter
    gradients."""
    params = carry(jlayer, tlayer)
    return compare(jlayer, tlayer, args, grad=grad, rel=rel,
                   params=params if grad else (), **kw)


X = arr((3, 8), -3.0, 3.0)
X4 = arr((2, 4, 3, 3), -2.0, 2.0, seed=3)

# (name, positional args after x, keyword args)
FUNCTIONALS = [
    ("relu", (), {}), ("relu6", (), {}), ("gelu", (), {}),
    ("gelu", (), dict(approximate=True)), ("sigmoid", (), {}),
    ("tanh", (), {}), ("softmax", (), {}), ("softmax", (0,), {}),
    ("softmax", (), dict(dtype="float64")), ("log_softmax", (), {}),
    ("log_softmax", (), dict(axis=0, dtype="float64")),
    ("leaky_relu", (), {}), ("leaky_relu", (0.2,), {}), ("elu", (0.7,), {}),
    ("selu", (), {}), ("celu", (), dict(alpha=1.5)), ("silu", (), {}),
    ("swish", (), {}), ("mish", (), {}), ("softplus", (), {}),
    ("softplus", (2.0, 1.5), {}), ("softsign", (), {}), ("hardtanh", (), {}),
    ("hardsigmoid", (), {}), ("hardswish", (), {}), ("hardshrink", (), {}),
    ("softshrink", (0.3,), {}), ("tanhshrink", (), {}),
    ("thresholded_relu", (), {}), ("log_sigmoid", (), {}),
    ("glu", (), {}), ("maxout", (2,), dict(axis=1)),
]


@pytest.mark.parametrize("name,args,kw", FUNCTIONALS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(FUNCTIONALS)])
def test_functional(name, args, kw):
    x = X4 if name == "maxout" else X
    grad = "float64" not in kw.values()
    compare(lambda a: getattr(JF, name)(a, *args, **kw),
            lambda a: getattr(TF, name)(a, *args, **kw), (x,), grad=grad)


def test_in_place_names_and_op_bindings():
    """``relu_``, ``tanh_``, ``softmax_``, ``elu_`` are the functional
    forms (as in the JAX package); ``sigmoid``/``tanh``/``pad`` are the
    op namespace's."""
    for name in ("relu_", "tanh_", "softmax_", "elu_"):
        compare(getattr(JF, name), getattr(TF, name), (X,))
    assert TF.sigmoid is pt.sigmoid and TF.tanh is pt.tanh
    assert TF.pad is pt.pad
    assert TF.activation.prelu is not None


def test_prelu_and_softmax_with_cross_entropy():
    w1 = np.array([0.25], np.float32)
    w4 = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    compare(JF.prelu, TF.prelu, (X4, w1))
    compare(JF.prelu, TF.prelu, (X4, w4))
    compare(JF.prelu, TF.prelu, (np.moveaxis(X4, 1, -1).copy(), w4),
            kw=dict(data_format="NHWC"))
    lab = np.array([[1], [7], [3]], np.int64)
    compare(JF.softmax_with_cross_entropy, TF.softmax_with_cross_entropy,
            (X, lab))
    soft = JF.softmax(paddle_tpu.to_tensor(arr((3, 8), seed=4))).numpy()
    compare(lambda a, b: JF.softmax_with_cross_entropy(
        a, b, soft_label=True, return_softmax=True),
        lambda a, b: TF.softmax_with_cross_entropy(
        a, b, soft_label=True, return_softmax=True), (X, soft))


def test_gumbel_softmax_by_shape_and_sums():
    """Random: shape, rows summing to 1, and with ``hard`` an exact
    one-hot whose gradient is the soft sample's."""
    x = pt.to_tensor(X, stop_gradient=False)
    soft = TF.gumbel_softmax(x, temperature=0.5)
    assert soft.shape == [3, 8]
    np.testing.assert_allclose(soft.numpy().sum(-1), 1.0, rtol=1e-6)
    hard = TF.gumbel_softmax(x, hard=True)
    h = hard.numpy()
    assert set(np.unique(h)) <= {0.0, 1.0}
    np.testing.assert_array_equal(h.sum(-1), 1.0)
    (hard * pt.to_tensor(arr((3, 8), seed=5))).sum().backward()
    assert np.isfinite(x.gradient()).all() and np.abs(x.gradient()).max() > 0
    jh = JF.gumbel_softmax(paddle_tpu.to_tensor(X), hard=True).numpy()
    assert jh.shape == h.shape and np.array_equal(jh.sum(-1), h.sum(-1))
    import torch

    g = torch.Generator().manual_seed(3)
    a = TF.gumbel_softmax(x, generator=g).numpy()
    b = TF.gumbel_softmax(x, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a, b.numpy())


# (layer, constructor args): every activation layer of the reference
LAYERS = [
    ("ReLU", ()), ("ReLU6", ()), ("GELU", ()), ("GELU", (True,)),
    ("Sigmoid", ()), ("Tanh", ()), ("Softmax", ()), ("Softmax", (0,)),
    ("LogSoftmax", ()), ("LeakyReLU", (0.1,)), ("ELU", (0.5,)), ("SELU", ()),
    ("CELU", (2.0,)), ("Silu", ()), ("Swish", ()), ("Mish", ()),
    ("Softplus", (2.0, 3.0)), ("Softsign", ()), ("Hardtanh", (-0.5, 0.5)),
    ("Hardsigmoid", ()), ("Hardswish", ()), ("Hardshrink", (0.6,)),
    ("Softshrink", ()), ("Tanhshrink", ()), ("ThresholdedReLU", (0.5,)),
    ("LogSigmoid", ()), ("GLU", ()), ("Maxout", (2,)),
]


def test_activation_layers():
    for name, args in LAYERS:
        x = X4 if name == "Maxout" else X
        compare_layers(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                       (x,))


def test_prelu_layer():
    """One slope and one per channel, NCHW and NHWC; the initial value."""
    for num, fmt in ((1, "NCHW"), (4, "NCHW"), (4, "NHWC")):
        x = X4 if fmt == "NCHW" else np.moveaxis(X4, 1, -1).copy()
        jl = jnn.PReLU(num, init=0.3, data_format=fmt)
        tl = tnn.PReLU(num, init=0.3, data_format=fmt)
        np.testing.assert_array_equal(tl.weight.numpy(), jl.weight.numpy())
        jl.set_state_dict({"weight": paddle_tpu.to_tensor(
            arr((num,), 0.1, 0.5, seed=6))})
        compare_layers(jl, tl, (x,))
