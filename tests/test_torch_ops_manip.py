"""The port's shape manipulation ops against paddle_tpu's (the first half
of ``ops/manipulation.py``: reshapes, transposes, joins and splits,
broadcasts, flips, slices): output and gradient on the same seeded numpy
inputs (the helpers of ``test_torch_ops_math.py``; these ops move values,
so outputs and gradients agree within float32 rounding, rtol = atol =
1e-5). The gathers and scatters are in ``test_torch_ops_scatter.py``.
"""
import numpy as np
import pytest

import paddle_tpu

import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

X = arr((2, 3, 4))
M = arr((3, 4), seed=1)

CASES = [
    ("reshape", (X, [4, 6]), {}), ("reshape", (X, [-1, 4]), {}),
    ("view", (X, [6, 4]), {}),
    ("flatten", (X,), {}), ("flatten", (X,), dict(start_axis=1)),
    ("transpose", (X, [2, 0, 1]), {}), ("t", (M,), {}),
    ("squeeze", (arr((2, 1, 3, 1)),), {}),
    ("squeeze", (arr((2, 1, 3, 1)),), dict(axis=1)),
    ("squeeze", (arr((2, 1, 3, 1)),), dict(axis=[0, 3])),
    ("unsqueeze", (M, 0), {}), ("unsqueeze", (M, [0, -1]), {}),
    ("tile", (M, [2, 1]), {}), ("tile", (M, [2, 1, 3]), {}),
    ("expand", (arr((1, 4)), [3, 4]), {}),
    ("expand", (arr((3, 1)), [2, -1, 4]), {}),
    ("broadcast_to", (arr((1, 4)), [3, 4]), {}),
    ("flip", (X, 1), {}), ("flip", (X, [0, 2]), {}),
    ("roll", (X, 2), dict(axis=1)), ("roll", (X, 3), {}),
    ("rot90", (M,), {}), ("rot90", (X,), dict(k=2, axes=[1, 2])),
    ("moveaxis", (X, 0, 2), {}),
    ("slice", (X, [1, 2], [0, 1], [2, 10]), {}),
    ("slice", (X, [2], [-3], [-1]), {}),
    ("strided_slice", (X, [1, 2], [0, 3], [3, 0], [2, -1]), {}),
    ("diagonal", (X,), dict(offset=1, axis1=1, axis2=2)),
    ("repeat_interleave", (M, 2), dict(axis=1)),
    ("unfold", (arr((2, 7)), 1, 3, 2), {}),
    ("crop", (X,), dict(shape=[2, 2, 3], offsets=[0, 1, 1])),
    ("clip_by_norm", (M, 0.5), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_manipulation(name, args, kw):
    check(name, *args, **kw)


def test_joins_and_splits():
    a, b = arr((2, 3)), arr((2, 3), seed=1)
    check("concat", [a, b], axis=1)
    check("stack", [a, b], axis=0)
    check("broadcast_tensors", [arr((1, 3)), arr((2, 1), seed=1)])
    check("split", X, 2, axis=2)
    check("split", X, [1, -1], axis=1)
    check("chunk", X, 3, axis=1)
    check("unstack", X, axis=1)
    check("unbind", X)
    for pkg in (paddle_tpu, pt):
        with pytest.raises(ValueError):
            pkg.split(pkg.to_tensor(np.arange(7.0)), 2)
        with pytest.raises(ValueError):
            pkg.expand(pkg.arange(3).astype("float32"), [-1, 3])


def test_cast_expand_as_and_complex_views():
    check("cast", M, "float64", grad=False)
    check("cast", M * 10, "int32", grad=False)
    check("expand_as", arr((1, 4)), M)
    pair = arr((3, 2))
    check("as_complex", pair, grad=False)
    for pkg in (paddle_tpu, pt):
        z = pkg.as_complex(pkg.to_tensor(pair))
        np.testing.assert_allclose(np.asarray(pkg.as_real(z).numpy()), pair)


def test_tensordot_and_diag_embed():
    check("tensordot", arr((2, 3, 4)), arr((3, 4, 5), seed=1))
    check("tensordot", M, arr((4, 2), seed=2), axes=1)
    check("diag_embed", arr((2, 3)))
    check("diag_embed", arr((2, 3)), offset=1)
