"""The port's gathers, scatters, masks and data-dependent ops against
paddle_tpu's (the second half of ``ops/manipulation.py``): output and
gradient on the same seeded numpy inputs (the helpers of
``test_torch_ops_math.py``; float32, rtol = atol = 1e-5). Indices are
distinct where a scatter writes, so no result depends on the order of
duplicate writes.
"""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

X = arr((4, 3))
X3 = arr((2, 3, 4), seed=1)
IDX = np.array([2, 0])

CASES = [
    ("gather", (X, IDX), {}), ("gather", (X3, np.array([3, 1])),
                              dict(axis=2)),
    ("gather_nd", (X3, np.array([[0, 1], [1, 2]])), {}),
    ("gather_nd", (X3, np.array([[1, 2, 3], [0, 0, 1]])), {}),
    ("index_select", (X3, np.array([0, 2])), dict(axis=1)),
    ("index_sample", (X, np.array([[0, 2], [1, 1], [2, 0], [0, 0]])), {}),
    ("take_along_axis", (X3, np.array([[[0], [2], [1]]]).repeat(2, 0)),
     dict(axis=2)),
    ("put_along_axis", (X, np.array([[0], [2], [1], [0]]), 5.0, 1), {}),
    ("put_along_axis", (X, np.array([[0], [2], [1], [0]]),
                        arr((4, 1), seed=4), 1), dict(reduce="add")),
    ("scatter", (X, IDX, arr((2, 3), seed=2)), {}),
    ("scatter", (X, IDX, arr((2, 3), seed=2)), dict(overwrite=False)),
    ("scatter_nd_add", (X3, np.array([[0, 1], [1, 2]]), arr((2, 4), seed=3)),
     {}),
    ("index_add", (X3, np.array([0, 2]), 1, arr((2, 2, 4), seed=3)), {}),
    ("index_fill", (X3, np.array([1, 3]), 2, 0.5), {}),
    ("masked_fill", (X, X > 0.2, -1.0), {}),
    ("where", (X > 0, X, arr((4, 3), seed=5)), {}),
    ("pad", (X3, [1, 2]), dict(data_format="NCL")),
    ("pad", (X3, [1, 0, 2, 1, 0, 3]), dict(value=0.5)),
    ("pad", (X3, [2, 1]), dict(mode="reflect", data_format="NCL")),
    ("pad", (X3, [1, 2]), dict(mode="replicate", data_format="NLC")),
    ("pad", (X3, [1, 2]), dict(mode="circular", data_format="NCL")),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_gather_scatter(name, args, kw):
    check(name, *args, **kw)


def test_put_along_axis_multiply():
    """Output only: the JAX package cannot differentiate its scatter
    product (``scatter_mul`` without unique indices)."""
    check("put_along_axis", X, np.array([[0], [2], [1], [0]]),
          arr((4, 1), seed=4), -1, reduce="multiply", grad=False)


def test_scatter_nd_and_index_put():
    idx = np.array([[0, 1], [1, 0]])
    upd = arr((2, 4), seed=6)
    check("scatter_nd", idx, upd, [2, 3, 4])
    check("index_put", X, (np.array([0, 3]), np.array([2, 1])),
          arr((2,), seed=7))
    check("index_put", X, (np.array([0, 3]), np.array([2, 1])),
          arr((2,), seed=7), accumulate=True)


def test_masked_select_nonzero_unique():
    """Output sizes that depend on the data (a host read in both). The
    JAX package's ``masked_select`` reads the host and has no gradient;
    the port's is differentiable (Paddle's is): ones where selected."""
    check("masked_select", X, X > 0.1, grad=False)
    x = pt.to_tensor(X, stop_gradient=False)
    pt.masked_select(x, pt.to_tensor(X > 0.1)).sum().backward()
    np.testing.assert_array_equal(x.gradient(), (X > 0.1).astype(np.float32))
    a = np.array([[3, 0, 1], [1, 0, 3]])
    check("nonzero", a, grad=False)
    check("nonzero", a, as_tuple=True, grad=False)
    check("where", a, grad=False)
    check("unique", a, grad=False)
    check("unique", a, return_index=True, return_inverse=True,
          return_counts=True, grad=False)
    check("unique_consecutive", np.array([1, 1, 2, 2, 3, 1, 1]),
          return_inverse=True, return_counts=True, grad=False)


def test_shard_index():
    ids = np.array([[1], [6], [12], [19]])
    for shard in (0, 1, 3):
        check("shard_index", ids, 20, 4, shard, grad=False)
    for pkg in (paddle_tpu, pt):
        with pytest.raises(ValueError):
            pkg.shard_index(pkg.to_tensor(ids), 20, 4, 4)


def test_put_along_axis_negative_axis():
    for pkg in (paddle_tpu, pt):
        out = pkg.put_along_axis(pkg.zeros([2, 3]), pkg.to_tensor(
            np.array([[0], [2]])), 5.0, axis=-1)
        np.testing.assert_allclose(np.asarray(out.numpy()),
                                   [[5, 0, 0], [0, 0, 5]])
