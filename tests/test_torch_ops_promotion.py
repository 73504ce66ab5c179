"""The port's promotion of integer and bool inputs, and its stated
departures, against paddle_tpu.

Ops that compute only in floats take int64 and bool tensors in the
default float type, and ``abs``/``ceil``/``floor``/``trunc`` keep a bool
tensor bool, as jnp promotes them (``ops/_dispatch.py``'s ``float_args``
and ``bool_args``). Each family runs its ops on the same int64
``[[1,5,3,2],[4,0,7,6],[9,8,2,1]]`` (or the bool ``[3,4]`` of its odd
entries) in both packages and compares the result's type (the port's
int64 where the JAX package, without x64, gives int32: the stated
departure) and value: float32 rtol = atol = 1e-5; ``qr`` and ``svd``,
whose signs are free, by the matrix their factors rebuild and by the
singular values, at the linear algebra tests' 1e-4.

Pinned: ``histogram`` counts in int64 (upstream Paddle's type; the JAX
package's float32 has the same values); ``eigh``/``eigvalsh`` read the
``UPLO`` triangle (equal on a symmetric input; on ``[[1,2],[0,3]]`` the
JAX package symmetrizes and gives [0.5858, 3.4142], the port [1, 3]);
``lstsq`` gives the JAX package's minimum-norm solution and its
residuals ``|b - a x|^2`` per column for any shape of system.
"""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import cpu_device  # noqa: F401

I64 = np.array([[1, 5, 3, 2], [4, 0, 7, 6], [9, 8, 2, 1]], dtype=np.int64)
I64_B = np.array([[2, 1, 0, 3], [1, 1, 4, 0], [0, 2, 1, 5]], dtype=np.int64)
BOOL = I64 % 2 == 1
RHS = np.array([[1, 2], [0, 1], [3, 1]], dtype=np.int64)
TOL = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=1e-4, atol=1e-4)


def _run(pkg, name, args, kw):
    out = getattr(pkg, name)(*[pkg.to_tensor(a) for a in args], **kw)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o.numpy()) for o in outs]


def _same(name, jout, tout, tol=TOL):
    assert len(jout) == len(tout), name
    for jv, tv in zip(jout, tout):
        assert tv.shape == jv.shape, (name, tv.shape, jv.shape)
        want = np.int64 if jv.dtype == np.int32 else jv.dtype
        assert tv.dtype == want, (name, tv.dtype, jv.dtype)
        if jv.dtype.kind in "fc":
            np.testing.assert_allclose(tv, jv, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=name)


def check_both(name, *args, tol=TOL, **kw):
    """``name`` on the same numpy ``args`` in both packages: each output's
    type and value."""
    jout = _run(paddle_tpu, name, args, kw)
    tout = _run(pt, name, args, kw)
    _same(name, jout, tout, tol)
    return jout, tout


INT_REDUCTIONS = [("median", {}), ("nanmedian", {}), ("std", {}),
                  ("var", {}), ("nanmean", {}), ("std", dict(axis=1)),
                  ("quantile", dict(q=0.3, axis=0, keepdim=True))]


@pytest.mark.parametrize("name,kw", INT_REDUCTIONS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(INT_REDUCTIONS)])
def test_int64_reductions(name, kw):
    jout, _ = check_both(name, I64, **kw)
    assert jout[0].dtype == np.float32


INT_LINALG = [("pinv", (I64,), {}), ("cond", (I64[:, :3],), {}),
              ("matrix_rank", (I64,), {}), ("lstsq", (I64, RHS), {}),
              ("dist", (I64, I64_B), {}),
              ("dist", (I64, I64_B), dict(p=1))]


@pytest.mark.parametrize("name,args,kw", INT_LINALG,
                         ids=[f"{c[0]}{i}" for i, c in
                              enumerate(INT_LINALG)])
def test_int64_linalg(name, args, kw):
    check_both(name, *args, tol=LOOSE, **kw)


@pytest.mark.parametrize("name", ["qr", "svd"])
def test_int64_decompositions_by_what_they_rebuild(name):
    a = I64.astype(np.float32)
    for pkg in (paddle_tpu, pt):
        outs = _run(pkg, name, (I64,), {})
        assert all(o.dtype == np.float32 for o in outs), (name, pkg)
        if name == "qr":
            q, r = outs
            np.testing.assert_allclose(q @ r, a, **LOOSE)
            np.testing.assert_allclose(q.T @ q, np.eye(3), **LOOSE)
        else:
            u, s, vh = outs
            np.testing.assert_allclose(u @ np.diag(s) @ vh, a, **LOOSE)
            np.testing.assert_allclose(s, np.linalg.svd(a)[1], **LOOSE)


INT_BINARY = ["hypot", "logaddexp", "nextafter", "polar"]


@pytest.mark.parametrize("name", INT_BINARY)
def test_int64_binary_math(name):
    jout, _ = check_both(name, I64, I64_B)
    assert jout[0].dtype in (np.float32, np.complex64)


BOOL_OPS = [("abs", {}), ("ceil", {}), ("floor", {}), ("trunc", {}),
            ("argmax", {}), ("argmin", dict(axis=1)), ("cov", {}),
            ("corrcoef", {}), ("median", {}), ("std", {})]


@pytest.mark.parametrize("name,kw", BOOL_OPS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(BOOL_OPS)])
def test_bool_ops(name, kw):
    jout, _ = check_both(name, BOOL, **kw)
    if name in ("abs", "ceil", "floor", "trunc"):
        assert jout[0].dtype == np.bool_


def test_histogram_counts_in_int64():
    """The stated departure, named in the docstring: the same counts,
    int64 where the JAX package gives float32."""
    assert "float32" in pt.histogram.__doc__
    for kw in ({}, dict(bins=4, min=0, max=9)):
        (j,), (t,) = (_run(pkg, "histogram", (I64,), kw)
                      for pkg in (paddle_tpu, pt))
        assert j.dtype == np.float32 and t.dtype == np.int64
        np.testing.assert_array_equal(t, j.astype(np.int64))
        assert t.sum() == I64.size


SYM = np.array([[2, 1], [1, 3]], dtype=np.float32)
UPPER = np.array([[1, 2], [0, 3]], dtype=np.float32)


@pytest.mark.parametrize("name", ["eigh", "eigvalsh"])
def test_eigh_reads_one_triangle(name):
    """Symmetric: the packages agree. Not symmetric: the port reads the
    lower triangle (numpy's answer), the JAX package the symmetrized
    matrix. The docstring names the difference."""
    assert "symmetrizes" in getattr(pt, name).__doc__ + pt.eigh.__doc__
    jw, tw = (_run(pkg, name, (SYM,), {})[0] for pkg in (paddle_tpu, pt))
    np.testing.assert_allclose(tw, jw, **TOL)
    jw, tw = (_run(pkg, name, (UPPER,), {})[0] for pkg in (paddle_tpu, pt))
    np.testing.assert_allclose(tw, np.linalg.eigvalsh(UPPER), **TOL)
    np.testing.assert_allclose(tw, [1.0, 3.0], **TOL)
    np.testing.assert_allclose(
        jw, np.linalg.eigvalsh((UPPER + UPPER.T) / 2), **TOL)
    np.testing.assert_allclose(jw, [2 - np.sqrt(2), 2 + np.sqrt(2)], **TOL)


A_WIDE = np.random.RandomState(0).uniform(-1, 1, (3, 4)).astype(np.float32)
A_TALL = np.random.RandomState(1).uniform(-1, 1, (5, 3)).astype(np.float32)
A_LOW_RANK = np.outer([1, 2, 3, 4], [1, -1, 2]).astype(np.float32)
LSTSQ = [("underdetermined", A_WIDE, RHS.astype(np.float32)),
         ("overdetermined", A_TALL, np.random.RandomState(2).uniform(
             -1, 1, (5, 2)).astype(np.float32)),
         ("vector_rhs", A_TALL, np.arange(5, dtype=np.float32)),
         ("rank_deficient", A_LOW_RANK, np.ones((4, 2), np.float32))]


@pytest.mark.parametrize("case,a,b", LSTSQ, ids=[c[0] for c in LSTSQ])
def test_lstsq_residuals_and_minimum_norm_solution(case, a, b):
    """Solution, residuals (shape and value), rank and singular values as
    the JAX package gives them; the solution is numpy's minimum-norm
    one."""
    jout, tout = check_both("lstsq", a, b, tol=LOOSE)
    np.testing.assert_allclose(
        tout[0], np.linalg.lstsq(a, b, rcond=None)[0], **LOOSE)
    resid = np.sum((b.reshape(len(b), -1) - a @ tout[0].reshape(
        a.shape[1], -1)) ** 2, axis=0)
    np.testing.assert_allclose(tout[1], resid, **LOOSE)
