"""The port's creation ops against paddle_tpu's: every name of
``ops/creation.py``'s ``__all__``. Deterministic ones give the same values
(float32 rtol = atol = 1e-5; integer results by value: the port's int64
against the JAX package's int32, which runs without x64). The random
ones draw from other streams in the two packages, so they are held to
their shape, type, range and statistics (within four standard errors of
the mean, n = 20000) and to ``paddle.seed`` reproducing them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu

import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401


def _same(jt, tt, tol=dict(rtol=1e-5, atol=1e-5)):
    j, t = np.asarray(jt.numpy()), tt.numpy()
    assert j.shape == t.shape
    if j.dtype.kind == "f":
        assert t.dtype == j.dtype
        np.testing.assert_allclose(t, j, **tol)
    else:
        np.testing.assert_array_equal(t, j)


CREATE = [
    ("zeros", ([2, 3],), {}), ("ones", ([2, 3],), dict(dtype="int32")),
    ("full", ([2, 2], 7), dict(dtype="int32")), ("full", ([3], 1.5), {}),
    ("empty", ([2, 3],), {}), ("arange", (5,), {}),
    ("arange", (1, 10, 3), {}), ("arange", (0.0, 1.0, 0.25), {}),
    ("linspace", (0, 1, 5), {}), ("eye", (3,), {}), ("eye", (2, 4), {}),
    ("tril_indices", (4, 3, 1), {}), ("triu_indices", (3, 4, -1), {}),
]


@pytest.mark.parametrize("name,args,kw", CREATE,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CREATE)])
def test_creation(name, args, kw):
    _same(getattr(paddle_tpu, name)(*args, **kw),
          getattr(pt, name)(*args, **kw))


def test_like_and_to_tensor():
    x = arr((2, 3))
    for name in ("zeros_like", "ones_like", "empty_like"):
        _same(getattr(paddle_tpu, name)(paddle_tpu.to_tensor(x)),
              getattr(pt, name)(pt.to_tensor(x)))
    _same(paddle_tpu.full_like(paddle_tpu.to_tensor(x), 2.5),
          pt.full_like(pt.to_tensor(x), 2.5))
    _same(paddle_tpu.to_tensor([[1.0, 2.0]]), pt.to_tensor([[1.0, 2.0]]))
    # the port keeps int64 where the JAX package (no x64) gives int32
    assert str(pt.to_tensor(1).dtype) == "torch.int64"
    assert str(pt.to_tensor(np.zeros(2)).dtype) == "torch.float32"


def test_matrix_builders():
    v, m = arr((3,)), arr((3, 4), seed=1)
    check("diag", v)
    check("diag", v, offset=1)
    check("diag", v, padding_value=9.0)
    check("diag", m, offset=-1)
    check("diagflat", m, offset=1)
    check("tril", m)
    check("triu", m, diagonal=1)
    check("meshgrid", arr((3,)), arr((2,), seed=1))
    check("polar", arr((3,), 0.5, 2.0), arr((3,), seed=2), grad=False)
    check("complex", arr((3,)), arr((3,), seed=2), grad=False)


def test_assign_and_clone():
    x = arr((2, 3))
    check("clone", x)
    check("assign", x)
    for pkg in (paddle_tpu, pt):
        out = pkg.zeros([2, 3])
        assert pkg.assign(pkg.to_tensor(x), out) is out
        np.testing.assert_allclose(np.asarray(out.numpy()), x)


def _stats(v, mean, std):
    n = v.size
    assert abs(v.mean() - mean) < 4 * std / np.sqrt(n) + 1e-6, v.mean()


def test_random_draws_follow_their_laws():
    n = [20000]
    pt.seed(11)
    u = pt.rand(n).numpy()
    assert u.dtype == np.float32 and u.min() >= 0 and u.max() < 1
    _stats(u, 0.5, np.sqrt(1 / 12))
    _stats(pt.randn(n).numpy(), 0.0, 1.0)
    _stats(pt.standard_normal(n).numpy(), 0.0, 1.0)
    uu = pt.uniform(n, min=-2.0, max=4.0).numpy()
    assert uu.min() >= -2 and uu.max() < 4
    _stats(uu, 1.0, np.sqrt(36 / 12))
    _stats(pt.normal(3.0, 2.0, n).numpy(), 3.0, 2.0)
    mean = pt.to_tensor(np.full(n, -1.0, np.float32))
    _stats(pt.normal(mean, 0.5).numpy(), -1.0, 0.5)
    r = pt.randint(2, 9, n)
    assert r.dtype == torch.int64 and r.numpy().min() >= 2 \
        and r.numpy().max() < 9
    perm = pt.randperm(50).numpy()
    assert sorted(perm.tolist()) == list(range(50))
    b = pt.bernoulli(pt.full(n, 0.3)).numpy()
    assert set(np.unique(b)) <= {0.0, 1.0}
    _stats(b, 0.3, np.sqrt(0.21))
    _stats(pt.poisson(pt.full(n, 4.0)).numpy(), 4.0, 2.0)
    m = pt.multinomial(pt.to_tensor(np.array([0.0, 1.0, 3.0], np.float32)),
                       2000, replacement=True).numpy()
    assert set(np.unique(m)) <= {1, 2}
    _stats(m.astype(np.float64), 1.75, np.sqrt(0.1875))
    rows = pt.multinomial(pt.to_tensor(np.ones((2, 5), np.float32)), 5)
    assert sorted(rows.numpy()[0].tolist()) == list(range(5))


def test_seed_reproduces_every_random_op():
    def draws():
        return [pt.rand([4]), pt.randn([4]), pt.randint(0, 100, [4]),
                pt.randperm(6), pt.uniform([4]), pt.normal(shape=[4]),
                pt.bernoulli(pt.full([4], 0.5)),
                pt.multinomial(pt.ones([4]), 2),
                pt.poisson(pt.full([4], 3.0))]

    pt.seed(5)
    a = [t.numpy() for t in draws()]
    pt.seed(5)
    b = [t.numpy() for t in draws()]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(pt.uniform([8], seed=1).numpy(),
                              pt.uniform([8], seed=2).numpy())
    np.testing.assert_array_equal(pt.uniform([8], seed=3).numpy(),
                                  pt.uniform([8], seed=3).numpy())


def test_default_dtype_drives_float_creation():
    pt.set_default_dtype("float64")
    try:
        assert pt.zeros([2]).dtype == torch.float64
        assert pt.to_tensor(1.5).dtype == torch.float64
        assert pt.get_default_dtype() == "float64"
    finally:
        pt.set_default_dtype("float32")
    with pytest.raises(TypeError):
        pt.set_default_dtype("int32")
