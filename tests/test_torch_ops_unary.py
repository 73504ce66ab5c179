"""The port's unary elementwise ops against paddle_tpu's (the stepwise
ones are in ``test_torch_ops_special.py``): output and gradient on the
same seeded numpy inputs, each in the op's domain (the helpers and
tolerances of ``test_torch_ops_math.py``: float32, rtol = atol = 1e-5;
the special functions 1e-4, computed by other series in the two
libraries).
"""
import numpy as np
import pytest

from test_torch_ops_math import arr, check, cpu_device  # noqa: F401
from helpers.torch_threads import one_torch_thread  # noqa: F401

X = arr((3, 4), -2.0, 2.0)
U = arr((3, 4), -0.9, 0.9, seed=1)     # (-1, 1)
P = arr((3, 4), 0.2, 3.0, seed=2)      # positive
P1 = arr((3, 4), 1.2, 3.0, seed=3)     # > 1
PROB = arr((3, 4), 0.05, 0.95, seed=4)  # (0, 1)
# away from the integers, where frac jumps
STEP = np.round(X * 4) / 4 + 0.1

UNARY = [
    ("exp", X), ("expm1", X), ("log", P), ("log2", P), ("log10", P),
    ("log1p", P), ("sqrt", P), ("rsqrt", P), ("square", X), ("abs", X),
    ("neg", X), ("reciprocal", P), ("sin", X), ("cos", X), ("tan", U),
    ("asin", U), ("acos", U), ("atan", X), ("sinh", X), ("cosh", X),
    ("tanh", X), ("asinh", X), ("acosh", P1), ("atanh", U), ("erf", X),
    ("sigmoid", X), ("logit", PROB), ("rad2deg", X), ("deg2rad", X),
    ("frac", STEP), ("sign", X), ("sgn", X),
]
SPECIAL = [("erfinv", U), ("lgamma", P), ("digamma", P)]
# complex-valued semantics on real inputs (angle: 0 or pi; conj, real:
# the input; imag: zeros)
COMPLEX_ON_REAL = [("angle", X), ("conj", X), ("real", X), ("imag", X)]


@pytest.mark.parametrize("name,x", UNARY, ids=[c[0] for c in UNARY])
def test_unary(name, x):
    check(name, x)


@pytest.mark.parametrize("name,x", SPECIAL, ids=[c[0] for c in SPECIAL])
def test_special_functions(name, x):
    check(name, x, tol=dict(rtol=1e-4, atol=1e-4))


def test_complex_views_of_real_inputs():
    for name, x in COMPLEX_ON_REAL:
        check(name, x, grad=name in ("conj", "real"))
