"""The rest of the port's ``ops/math.py`` against paddle_tpu's: the
stepwise roundings, Bessel and polygamma functions, integration,
Vandermonde matrices, bucketing, membership, flat gathers,
renormalisation and the predicates (the helpers of
``test_torch_ops_math.py``; float32, rtol = atol = 1e-5, the Bessel and
polygamma functions 1e-4: other series in the two libraries).
"""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

X = arr((3, 4), -2.0, 2.0)
P = arr((3, 4), 0.5, 3.0, seed=2)
SPECIAL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["floor", "ceil", "round", "trunc"])
def test_stepwise(name):
    """Away from the points where they jump (gradient zero in both)."""
    check(name, np.round(X * 4) / 4 + 0.1)


@pytest.mark.parametrize("name", ["i0", "i0e", "i1", "i1e"])
def test_bessel(name):
    check(name, X, tol=SPECIAL_TOL)


def test_polygamma():
    for n in (1, 2):
        check("polygamma", P, n, tol=SPECIAL_TOL)


def test_trapezoid_and_cumulative():
    y, x = arr((3, 6)), np.cumsum(arr((3, 6), 0.1, 1.0, seed=1), axis=1)
    for name in ("trapezoid", "cumulative_trapezoid"):
        check(name, y)
        check(name, y, dx=0.5, axis=0)
        check(name, y, x)


def test_vander():
    v = arr((5,), seed=3)
    check("vander", v)
    check("vander", v, n=3, increasing=True)


def test_nan_to_num():
    x = X.copy()
    x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
    check("nan_to_num", x, grad=False)
    check("nan_to_num", x, nan=1.0, posinf=9.0, neginf=-9.0, grad=False)


def test_predicates():
    x = X.copy()
    x[0, 0], x[1, 1] = np.inf, -np.inf
    for name in ("signbit", "isposinf", "isneginf", "isreal"):
        check(name, x, grad=False)


def test_bucketize_and_isin():
    seq = np.array([-1.0, -0.2, 0.3, 1.1], np.float32)
    check("bucketize", X, seq, grad=False)
    check("bucketize", X, seq, right=True, grad=False)
    check("bucketize", X, seq, out_int32=True, grad=False)
    a = np.random.RandomState(0).randint(0, 10, (3, 4))
    check("isin", a, np.array([1, 3, 5]), grad=False)
    check("isin", a, np.array([1, 3, 5]), invert=True, grad=False)


def test_take():
    idx = np.array([[0, 5], [-1, 11]])
    check("take", X, idx)
    check("take", X, np.array([13, -14, 3]), mode="wrap")
    check("take", X, np.array([13, -14, 3]), mode="clip")
    for pkg in (paddle_tpu, pt):
        with pytest.raises(IndexError):
            pkg.take(pkg.to_tensor(X), pkg.to_tensor(np.array([12])))


def test_renorm():
    check("renorm", X, 2.0, 0, 1.5)
    check("renorm", X, 1.0, 1, 2.0)


def test_numel():
    for pkg in (paddle_tpu, pt):
        assert int(pkg.numel(pkg.to_tensor(X)).numpy()) == 12
