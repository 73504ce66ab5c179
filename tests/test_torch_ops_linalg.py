"""The port's linear algebra against paddle_tpu's: output and gradient on
the same seeded numpy inputs (the helpers of ``test_torch_ops_math.py``).
Matrices are well conditioned (symmetric positive definite where a
factorization needs it). Tolerances: products and norms float32 rtol =
atol = 1e-5; factorizations and solves 1e-4 (LAPACK in torch against
XLA's own kernels, other orders of summation). Decompositions whose
factors are defined up to signs (SVD, QR, eigenvectors) compare the
invariant parts: singular values and eigenvalues, and the products that
rebuild the input.
"""
import numpy as np
import pytest

import paddle_tpu

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_ops_math import arr, check, cpu_device  # noqa: F401

A = arr((3, 4))
B = arr((4, 5), seed=1)
SQ = arr((4, 4), seed=2) + 4 * np.eye(4, dtype=np.float32)
_R = arr((4, 4), seed=3)
SPD = (_R @ _R.T + 4 * np.eye(4)).astype(np.float32)
RHS = arr((4, 2), seed=4)
LOOSE = dict(rtol=1e-4, atol=1e-4)

PRODUCTS = [
    ("matmul", (A, B), {}), ("matmul", (A, A), dict(transpose_y=True)),
    ("matmul", (A, A), dict(transpose_x=True)),
    ("matmul", (arr((2, 3, 4)), arr((4, 2), seed=5)), {}),
    ("mm", (A, B), {}), ("bmm", (arr((2, 3, 4)), arr((2, 4, 5), seed=5)), {}),
    ("mv", (A, arr((4,), seed=6)), {}), ("dot", (A, arr((3, 4), seed=6)), {}),
    ("addmm", (arr((3, 5), seed=7), A, B), dict(beta=0.5, alpha=2.0)),
    ("multi_dot", ([A, B, arr((5, 2), seed=8)],), {}),
    ("cross", (arr((2, 3)), arr((2, 3), seed=9)), {}),
    ("cdist", (arr((3, 4)), arr((5, 4), seed=9)), {}),
    ("cdist", (arr((3, 4)), arr((5, 4), seed=9)), dict(p=1.0)),
    ("dist", (A, arr((3, 4), seed=10)), {}),
    ("dist", (A, arr((3, 4), seed=10)), dict(p=1)),
]


@pytest.mark.parametrize("name,args,kw", PRODUCTS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(PRODUCTS)])
def test_products(name, args, kw):
    check(name, *args, **kw)


def test_einsum():
    check("einsum", "ij,jk->ik", A, B)
    check("einsum", "bij->bji", arr((2, 3, 4)))


NORMS = [dict(), dict(p="fro", axis=[0, 1]), dict(p=2, axis=1),
         dict(p=1, axis=0, keepdim=True), dict(p=float("inf"), axis=1),
         dict(p=3), dict(p="fro", keepdim=True)]


def test_norm():
    for kw in NORMS:
        check("norm", A, **kw)


SQUARE = [("inverse", (SQ,), {}), ("det", (SQ,), {}),
          ("slogdet", (SQ,), {}), ("matrix_power", (SQ, 3), {}),
          ("matrix_exp", (SQ / 4,), {}), ("solve", (SQ, RHS), {}),
          ("cholesky", (SPD,), {}), ("cholesky", (SPD,), dict(upper=True)),
          ("triangular_solve", (np.triu(SQ), RHS), {}),
          ("triangular_solve", (np.tril(SQ), RHS), dict(upper=False)),
          ("triangular_solve", (np.triu(SQ), RHS), dict(transpose=True)),
          ("cholesky_solve", (RHS, np.linalg.cholesky(SPD).astype(
              np.float32)), {}),
          ("pinv", (A,), {}), ("eigvalsh", (SPD,), {}),
          ("cond", (SQ,), {})]


@pytest.mark.parametrize("name,args,kw", SQUARE,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(SQUARE)])
def test_square_matrices(name, args, kw):
    check(name, *args, tol=LOOSE, **kw)


def test_statistics_and_counts():
    check("cov", arr((3, 6)), tol=LOOSE)
    check("cov", arr((6, 3)), rowvar=False, ddof=False, tol=LOOSE)
    check("corrcoef", arr((3, 6)), tol=LOOSE)
    check("bincount", np.array([0, 3, 3, 1, 5]), grad=False)
    check("bincount", np.array([0, 3, 3, 1]), minlength=6, grad=False)
    check("histogram", arr((50,), seed=3), bins=5, min=-1, max=1,
          grad=False)
    check("matrix_rank", np.diag([1.0, 2.0, 0.0]).astype(np.float32),
          grad=False)


def _np(t):
    return np.asarray(t.numpy())


def test_decompositions_by_their_invariants():
    for pkg in (paddle_tpu, pt):
        u, s, vh = (_np(t) for t in pkg.svd(pkg.to_tensor(A)))
        np.testing.assert_allclose(u @ np.diag(s) @ vh, A, **LOOSE)
        np.testing.assert_allclose(s, np.linalg.svd(A)[1], **LOOSE)
        q, r = (_np(t) for t in pkg.qr(pkg.to_tensor(B.T)))
        np.testing.assert_allclose(q @ r, B.T, **LOOSE)
        w, v = (_np(t) for t in pkg.eigh(pkg.to_tensor(SPD)))
        np.testing.assert_allclose(v @ np.diag(w) @ v.T, SPD, **LOOSE)
        ev = np.sort(_np(pkg.eigvals(pkg.to_tensor(SPD))).real)
        np.testing.assert_allclose(ev, np.linalg.eigvalsh(SPD), **LOOSE)
        w2, v2 = (_np(t) for t in pkg.eig(pkg.to_tensor(SPD)))
        np.testing.assert_allclose((v2 @ np.diag(w2) @ np.linalg.inv(v2)
                                    ).real, SPD, **LOOSE)
        lu, piv = (_np(t) for t in pkg.lu(pkg.to_tensor(SQ)))
        assert piv.dtype == np.int32 and piv.min() >= 1
        sol = _np(pkg.lstsq(pkg.to_tensor(B.T), pkg.to_tensor(
            arr((5, 2), seed=3)))[0])
        np.testing.assert_allclose(sol, np.linalg.lstsq(
            B.T, arr((5, 2), seed=3), rcond=None)[0], **LOOSE)
    jlu, jpiv = paddle_tpu.lu(paddle_tpu.to_tensor(SQ))
    tlu, tpiv = pt.lu(pt.to_tensor(SQ))
    np.testing.assert_allclose(tlu.numpy(), np.asarray(jlu.numpy()), **LOOSE)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv.numpy()))
