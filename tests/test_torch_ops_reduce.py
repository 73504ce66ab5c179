"""The port's reductions and scans against paddle_tpu's: output and
gradient on the same seeded numpy inputs, over all axes, one axis, two
axes and with ``keepdim`` (the helpers and tolerances of
``test_torch_ops_math.py``: float32, rtol = atol = 1e-5; quantiles
interpolate linearly in both).
"""
import numpy as np
import pytest

from test_torch_ops_math import arr, check, cpu_device  # noqa: F401
from helpers.torch_threads import one_torch_thread  # noqa: F401

X = arr((3, 4, 5))
# distinct values, so max/min/median pick one element in both packages
D = np.random.RandomState(5).permutation(60).reshape(3, 4, 5).astype(
    np.float32) / 10

AXES = [dict(), dict(axis=1), dict(axis=[0, 2]), dict(axis=-1, keepdim=True)]
REDUCTIONS = [("sum", X), ("mean", X), ("prod", X), ("max", D), ("min", D),
              ("amax", D), ("amin", D), ("logsumexp", X), ("std", X),
              ("var", X), ("nansum", X), ("nanmean", X)]


@pytest.mark.parametrize("name,x", REDUCTIONS,
                         ids=[c[0] for c in REDUCTIONS])
def test_reduction(name, x):
    for kw in AXES:
        check(name, x, **kw)


def test_reduction_options():
    check("sum", X, axis=1, dtype="float32")
    check("std", X, axis=1, unbiased=False)
    check("var", X, axis=[0, 1], unbiased=False, keepdim=True)
    check("sum", np.arange(12).reshape(3, 4), axis=0, grad=False)


@pytest.mark.parametrize("name", ["median", "nanmedian"])
def test_median(name):
    for kw in (dict(), dict(axis=1), dict(axis=2, keepdim=True)):
        check(name, D, **kw)


@pytest.mark.parametrize("name", ["quantile", "nanquantile"])
def test_quantile(name):
    for q in (0.3, 0.75):
        for kw in (dict(), dict(axis=1), dict(axis=0, keepdim=True)):
            check(name, D, q, **kw)


def test_all_any_count_nonzero():
    m = (X > 0.2)
    z = np.where(X > 0.3, X, 0).astype(np.float32)
    for kw in AXES:
        check("all", m, grad=False, **kw)
        check("any", m, grad=False, **kw)
        check("count_nonzero", z, grad=False, **kw)


SCANS = [("cumsum", dict(axis=1)), ("cumsum", dict()),
         ("cumprod", dict(dim=2)), ("cumprod", dict()),
         ("logcumsumexp", dict(axis=0)), ("logcumsumexp", dict()),
         ("cummax", dict(axis=1)), ("cummin", dict(axis=-1))]


@pytest.mark.parametrize("name,kw", SCANS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SCANS)])
def test_scan(name, kw):
    check(name, D if name in ("cummax", "cummin") else X, **kw)


def test_scan_dtype():
    check("cumsum", np.array([1, 2, 3], np.int32), dtype="float32",
          grad=False)


def test_trace():
    m = arr((4, 5))
    for kw in (dict(), dict(offset=1), dict(offset=-2)):
        check("trace", m, **kw)
    check("trace", X, axis1=1, axis2=2)
