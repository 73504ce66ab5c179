"""``paddle.distribution`` of the port against the JAX package's, on the
CPU: the same parameters and values give the same ``log_prob``,
``probs``, ``entropy`` and ``kl_divergence`` (float32, rtol 1e-5, atol
1e-6; ``-inf`` where the reference gives it), the gradient of
``log_prob`` in its value, and samples of the same shapes, supports and
moments (the two packages draw different numbers from one seed: a seeded
draw repeats within the port, and draws from the package's generator
otherwise). ``Categorical`` keeps the reference's two normalizations.
"""
import math

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import distribution as jd

import paddle_tpu_torch as pt
from paddle_tpu_torch import distribution as td
from test_torch_ops_math import cpu_device  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return np.asarray(t.numpy())


def _both(name, *args):
    return (getattr(jd, name)(*[paddle_tpu.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args]),
        getattr(td, name)(*[pt.to_tensor(a) if isinstance(a, np.ndarray)
                            else a for a in args]))


def _values(pkg, v):
    return pkg.to_tensor(np.asarray(v, np.float32))


LOW = np.array([1.0, -2.0, 0.5], np.float32)
HIGH = np.array([3.0, 0.0, 0.75], np.float32)
VALUES = np.array([[2.0, -1.0, 0.6], [5.0, 0.0, 0.7]], np.float32)


def test_uniform_matches_paddle_tpu():
    j, t = _both("Uniform", LOW, HIGH)
    for fn in ("log_prob", "probs"):
        want = _np(getattr(j, fn)(_values(paddle_tpu, VALUES)))
        got = getattr(t, fn)(_values(pt, VALUES)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert np.isneginf(t.log_prob(_values(pt, VALUES)).numpy()[1, 0])
    np.testing.assert_allclose(t.entropy().numpy(), _np(j.entropy()), **TOL)
    s = t.sample([500, 2]).numpy()
    assert s.shape == tuple(_np(j.sample([500, 2])).shape) == (500, 2, 3)
    assert (s >= LOW).all() and (s < HIGH).all()
    np.testing.assert_array_equal(t.sample([4], seed=7).numpy(),
                                  t.sample([4], seed=7).numpy())


def test_scalar_uniform_as_the_reference_test():
    u = td.Uniform(1.0, 3.0)
    s = u.sample([1000], seed=7).numpy()
    assert s.shape == (1000,) and (s >= 1.0).all() and (s < 3.0).all()
    np.testing.assert_allclose(u.entropy().numpy(), math.log(2.0),
                               rtol=1e-6)
    np.testing.assert_allclose(
        u.probs(pt.to_tensor(np.float32(2.0))).numpy(), 0.5, rtol=1e-6)


LOC = np.array([1.0, -0.5], np.float32)
SCALE = np.array([2.0, 0.25], np.float32)


def test_normal_matches_paddle_tpu():
    j, t = _both("Normal", LOC, SCALE)
    v = np.array([[1.0, 3.0], [-1.0, 0.0]], np.float32)
    for fn in ("log_prob", "probs"):
        np.testing.assert_allclose(
            getattr(t, fn)(_values(pt, v)).numpy(),
            _np(getattr(j, fn)(_values(paddle_tpu, v))), **TOL)
    np.testing.assert_allclose(t.entropy().numpy(), _np(j.entropy()), **TOL)
    j2, t2 = _both("Normal", np.zeros(2, np.float32),
                   np.ones(2, np.float32))
    np.testing.assert_allclose(t.kl_divergence(t2).numpy(),
                               _np(j.kl_divergence(j2)), **TOL)
    s = t.sample([4000]).numpy()
    assert s.shape == tuple(_np(j.sample([4000])).shape) == (4000, 2)
    np.testing.assert_allclose(s.mean(0), LOC, atol=0.1)
    np.testing.assert_allclose(s.std(0), SCALE, rtol=0.1)


def test_normal_log_prob_differentiates():
    """The policy-gradient use: ``log_prob`` carries a gradient to its
    value in both packages."""
    v = np.array([1.0, 3.0], np.float32)
    grads = []
    for pkg, dist in ((paddle_tpu, jd), (pt, td)):
        n = dist.Normal(1.0, 2.0)
        x = pkg.to_tensor(v)
        x.stop_gradient = False
        n.log_prob(x).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], -(v - 1.0) / 4.0, rtol=1e-5)


W = np.array([[1.0, 2.0, 1.0], [0.5, 0.5, 3.0]], np.float32)


@pytest.mark.parametrize("weights", [W[0], W])
def test_categorical_matches_paddle_tpu(weights):
    j, t = _both("Categorical", weights)
    idx = np.array([0, 1, 2]) if weights.ndim == 1 else np.array([2, 0])
    for fn in ("probs", "log_prob"):
        np.testing.assert_allclose(
            getattr(t, fn)(pt.to_tensor(idx)).numpy(),
            _np(getattr(j, fn)(paddle_tpu.to_tensor(idx))), **TOL)
    np.testing.assert_allclose(t.entropy().numpy(), _np(j.entropy()), **TOL)
    other = weights[..., ::-1].copy()
    j2, t2 = _both("Categorical", other)
    np.testing.assert_allclose(t.kl_divergence(t2).numpy(),
                               _np(j.kl_divergence(j2)), **TOL)
    s = t.sample([2000]).numpy()
    assert s.shape == tuple(_np(j.sample([2000])).shape)
    assert s.dtype == np.int64
    rows = s.reshape(2000, -1)
    p = weights.reshape(-1, 3) / weights.reshape(-1, 3).sum(-1,
                                                           keepdims=True)
    for r in range(rows.shape[1]):
        freq = np.bincount(rows[:, r], minlength=3) / 2000.0
        np.testing.assert_allclose(freq, p[r], atol=0.05)


def test_categorical_keeps_the_two_normalizations():
    """probs/log_prob sum-normalize the weights; entropy/kl_divergence
    exp-normalize them (the reference's departure, kept)."""
    w = W[0]
    c = td.Categorical(pt.to_tensor(w))
    np.testing.assert_allclose(
        c.probs(pt.to_tensor(np.array([0, 1, 2]))).numpy(),
        [0.25, 0.5, 0.25], rtol=1e-6)
    e = np.exp(w - w.max())
    ps = e / e.sum()
    np.testing.assert_allclose(c.entropy().numpy(),
                               -(ps * np.log(ps)).sum(), rtol=1e-6)


def test_draws_come_from_the_package_generator():
    prev = pt.core.random.get_seed()
    pt.seed(11)
    a = td.Normal(0.0, 1.0).sample([8]).numpy()
    c = td.Categorical(pt.to_tensor(W[0])).sample([8]).numpy()
    pt.seed(11)
    b = td.Normal(0.0, 1.0).sample([8]).numpy()
    d = td.Categorical(pt.to_tensor(W[0])).sample([8]).numpy()
    pt.seed(prev)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c, d)
