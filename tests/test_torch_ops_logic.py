"""The port's comparisons, logical ops and search/sort ops against
paddle_tpu's: every name of ``ops/logic.py`` and ``ops/search.py``, on the
same seeded numpy inputs (the helpers of ``test_torch_ops_math.py``;
boolean and index results exactly, sorted values and top-k values with
their gradients within float32 rtol = atol = 1e-5). Values are distinct
where an order decides an index, so ties cannot differ.
"""
import numpy as np
import pytest

import paddle_tpu

import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

X = arr((3, 4))
Y = np.where(arr((3, 4), seed=1) > 0, X, arr((3, 4), seed=2))
I = np.random.RandomState(3).randint(0, 16, (3, 4))
J = np.random.RandomState(4).randint(0, 16, (3, 4))
D = np.random.RandomState(5).permutation(24).reshape(4, 6).astype(
    np.float32)

COMPARE = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"]
LOGICAL = ["logical_and", "logical_or", "logical_xor"]
BITWISE = ["bitwise_and", "bitwise_or", "bitwise_xor"]


@pytest.mark.parametrize("name", COMPARE)
def test_compare(name):
    check(name, X, Y, grad=False)
    check(name, X, 0.1, grad=False)


@pytest.mark.parametrize("name", LOGICAL + BITWISE)
def test_logical_and_bitwise(name):
    a, b = (X > 0), (Y > 0.2)
    check(name, a, b, grad=False)
    if name in BITWISE:
        check(name, I, J, grad=False)


def test_unary_predicates():
    x = X.copy()
    x[0, 0], x[1, 1] = np.nan, np.inf
    for name in ("isnan", "isinf", "isfinite"):
        check(name, x, grad=False)
    check("logical_not", X > 0, grad=False)
    check("bitwise_not", I, grad=False)


def test_closeness():
    z = X + 1e-7
    for name in ("isclose", "allclose"):
        check(name, X, z, grad=False)
        check(name, X, Y, grad=False)
        check(name, X, Y, rtol=1.0, atol=1.0, grad=False)
    check("equal_all", X, X.copy(), grad=False)
    check("equal_all", X, Y, grad=False)


def test_is_empty_and_is_tensor():
    for pkg in (paddle_tpu, pt):
        assert bool(pkg.is_empty(pkg.zeros([0, 3])))
        assert not bool(pkg.is_empty(pkg.zeros([1])))
        assert pkg.is_tensor(pkg.zeros([1])) and not pkg.is_tensor(X)


SEARCH = [
    ("argmax", (D,), {}), ("argmax", (D,), dict(axis=1, keepdim=True)),
    ("argmin", (D,), dict(axis=0)), ("argsort", (D,), {}),
    ("argsort", (D,), dict(axis=0, descending=True)),
    ("index_of_max", (D,), {}),
    ("searchsorted", (np.array([0.5, 1.0, 3.0, 9.0], np.float32), D), {}),
    ("searchsorted", (np.array([1.0, 3.0, 9.0], np.float32), D),
     dict(right=True, out_int32=True)),
    ("mode", (np.array([[1, 3, 3, 2], [4, 4, 1, 1]]),), {}),
]


@pytest.mark.parametrize("name,args,kw", SEARCH,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SEARCH)])
def test_search(name, args, kw):
    check(name, *args, grad=False, **kw)


def test_sort_topk_kthvalue_with_gradients():
    check("sort", D)
    check("sort", D, axis=0, descending=True)
    check("topk", D, 3)
    check("topk", D, 2, axis=0, largest=False)
    check("kthvalue", D, 2)
    check("kthvalue", D, 3, axis=0, keepdim=True)
