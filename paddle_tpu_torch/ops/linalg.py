"""Linear algebra (counterpart of ``paddle_tpu/ops/linalg.py``): every
name of its ``__all__`` over ``torch.matmul`` and ``torch.linalg``. A
plain matmul stays ``torch.matmul`` (cuBLAS): the JAX package computes it
outside any Pallas kernel too. The factorizations, norms and statistics
take integer and bool inputs in the default float type, as jnp promotes
them (``_dispatch.float_args``).

Where the two differ: ``eigh``/``eigvalsh`` read one triangle (``UPLO``),
where jnp symmetrizes; ``histogram`` counts in int64, where the JAX
package returns float32; ranks are int64, where it gives int32.
"""
from __future__ import annotations

import builtins

import torch

from ..core.tensor import Tensor
from ._dispatch import apply, float_args, nondiff, raw, to_float

__all__ = [
    "addmm", "bincount", "bmm", "cholesky", "corrcoef", "cov", "cross",
    "det", "dist", "dot", "eigh", "eigvalsh", "einsum", "histogram",
    "inverse", "lstsq", "matmul", "matrix_power", "matrix_rank", "mm",
    "multi_dot", "mv", "norm", "pinv", "qr", "slogdet", "solve", "svd",
    "triangular_solve", "eig", "eigvals", "lu", "cholesky_solve",
    "matrix_exp", "cond", "cdist",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply(f, x, y, name="matmul")


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return apply(torch.matmul, x, y, name="bmm")


def mv(x, vec, name=None):
    return apply(torch.matmul, x, vec, name="mv")


def dot(x, y, name=None):
    return apply(lambda a, b: torch.sum(a * b, -1), x, y, name="dot")


def einsum(equation, *operands):
    return apply(lambda *rs: torch.einsum(equation, *rs), *operands,
                 name="einsum")


def _ord(p):
    if p in ("inf", float("inf")):
        return float("inf")
    if p == float("-inf"):
        return float("-inf")
    return p


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The Frobenius norm (default) or a vector ``p``-norm over all of
    ``x`` (axis None), one axis, or a matrix norm over two."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def f(a):
        if p == "fro" and (ax is None or isinstance(ax, tuple)):
            if ax is None:
                r = torch.sqrt(torch.sum(a * a))
                return r.reshape((1,) * a.dim()) if keepdim else r
            return torch.linalg.matrix_norm(a, "fro", ax, keepdim)
        o = 2 if p == "fro" else _ord(p)
        if ax is None:
            return torch.linalg.vector_norm(a.reshape(-1), o, 0, keepdim)
        if isinstance(ax, tuple):
            return torch.linalg.matrix_norm(a, o, ax, keepdim)
        return torch.linalg.vector_norm(a, o, ax, keepdim)

    return apply(f, x, name="norm")


def dist(x, y, p=2, name=None):
    return apply(float_args(lambda a, b: torch.linalg.vector_norm(
        (a - b).reshape(-1), _ord(p))), x, y, name="dist")


def cross(x, y, axis=None, name=None):
    """The cross product along ``axis`` (default: the first axis of
    length 3)."""
    shape = raw(x).shape
    ax = axis if axis is not None else next(
        (i for i, d in enumerate(shape) if d == 3), -1)
    return apply(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y,
                 name="cross")


def cholesky(x, upper=False, name=None):
    return apply(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                 name="cholesky")


def inverse(x, name=None):
    return apply(torch.linalg.inv, x, name="inverse")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(float_args(lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian)), x, name="pinv")


def slogdet(x, name=None):
    return apply(lambda a: tuple(torch.linalg.slogdet(a)), x,
                 name="slogdet")


def det(x, name=None):
    return apply(torch.linalg.det, x, name="det")


def matrix_power(x, n, name=None):
    return apply(lambda a: torch.linalg.matrix_power(a, n), x,
                 name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return nondiff(float_args(lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian)), "matrix_rank")(x)


def svd(x, full_matrices=False, name=None):
    return apply(float_args(lambda a: tuple(torch.linalg.svd(
        a, full_matrices=full_matrices))), x, name="svd")


def qr(x, mode="reduced", name=None):
    return apply(float_args(lambda a: tuple(torch.linalg.qr(a, mode))), x,
                 name="qr")


def eigh(x, UPLO="L", name=None):
    """Eigenvalues (ascending) and eigenvectors of the symmetric matrix
    whose ``UPLO`` triangle ``x`` holds; the other triangle is not read,
    as upstream Paddle and numpy do. The JAX package symmetrizes
    (``(x + x^H) / 2``) first, so the two agree on symmetric inputs only:
    for ``[[1, 2], [0, 3]]`` it gives [0.5858, 3.4142], this [1, 3]."""
    return apply(lambda a: tuple(torch.linalg.eigh(a, UPLO)), x,
                 name="eigh")


def eigvalsh(x, UPLO="L", name=None):
    """The eigenvalues of :func:`eigh`, read from the same triangle."""
    return apply(lambda a: torch.linalg.eigvalsh(a, UPLO), x,
                 name="eigvalsh")


def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y, name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x @ out = y`` (``x^T @ out = y`` with ``transpose``) for a
    triangular ``x``."""
    def f(a, b):
        if transpose:
            return torch.linalg.solve_triangular(
                a.transpose(-1, -2), b, upper=not upper,
                unitriangular=unitriangular)
        return torch.linalg.solve_triangular(a, b, upper=upper,
                                             unitriangular=unitriangular)

    return apply(f, x, y, name="triangular_solve")


def _lstsq(a, b, rcond):
    """jnp.linalg.lstsq's algorithm: the minimum-norm solution through the
    SVD of ``a`` ``[M, N]``, singular values below ``rcond`` times the
    largest cut (``rcond`` None: eps * max(M, N)); residuals are
    ``|b - a x|^2`` per column of ``b`` ``[M]`` or ``[M, K]`` whatever the
    rank and shape (``(1,)`` for a vector ``b``)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    eps = torch.finfo(dtype).eps
    cut = eps * builtins.max(a.shape) if rcond is None else (
        eps if rcond < 0 else rcond)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= cut * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0).to(dtype)
    sol = vh.mH @ (s_inv[:, None] * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, mask.sum(), s


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) of the least-squares
    problem ``x @ solution = y``, computed as the JAX package computes
    them (:func:`_lstsq`), on either device; ``driver`` is not read (on
    the card torch has only ``gels``, which assumes a full-rank ``x``)."""
    with torch.no_grad():
        return apply(lambda a, b: _lstsq(to_float(a), to_float(b), rcond),
                     x, y, name="lstsq")


def multi_dot(tensors, name=None):
    return apply(lambda *rs: torch.linalg.multi_dot(rs), *tensors,
                 name="multi_dot")


def histogram(x, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over [min, max] (the data's range
    when both are 0), as int64, upstream Paddle's type; the JAX package
    returns them as float32 (the same values)."""
    def f(a):
        a = a.float()
        lo, hi = (min, max) if (min != 0 or max != 0) else (
            float(a.min()), float(a.max()))
        return torch.histc(a, bins, lo, hi).long()

    return nondiff(f, "histogram")(x)


def bincount(x, weights=None, minlength=0, name=None):
    w = raw(weights) if weights is not None else None
    return nondiff(lambda a: torch.bincount(a, w, minlength),
                   "bincount")(x)


def corrcoef(x, rowvar=True, name=None):
    return apply(float_args(lambda a: torch.corrcoef(
        a if rowvar else a.t())), x, name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply(float_args(lambda a: torch.cov(
        a if rowvar else a.t(), correction=int(bool(ddof)))), x, name="cov")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 input, x, y, name="addmm")


def eig(x, name=None):
    return apply(lambda a: tuple(torch.linalg.eig(a)), x, name="eig")


def eigvals(x, name=None):
    return apply(torch.linalg.eigvals, x, name="eigvals")


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factor and the 1-based pivots (int32); with
    ``get_infos`` also the factorization's info codes."""
    if not pivot:
        raise NotImplementedError("lu(pivot=False) is not supported")
    lu_t, piv = apply(lambda a: tuple(torch.linalg.lu_factor(a)), x,
                      name="lu")
    piv = Tensor._wrap(piv._data.to(torch.int32))
    if get_infos:
        info = Tensor._wrap(torch.zeros(lu_t.shape[:-2], dtype=torch.int32,
                                        device=lu_t._data.device))
        return lu_t, piv, info
    return lu_t, piv


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A @ out = x`` given ``y``, the Cholesky factor of ``A``
    (only its triangle is read, so only the triangle gets a gradient)."""
    return apply(lambda b, c: torch.cholesky_solve(
        b, torch.triu(c) if upper else torch.tril(c), upper), x, y,
        name="cholesky_solve")


def matrix_exp(x, name=None):
    return apply(torch.linalg.matrix_exp, x, name="matrix_exp")


def cond(x, p=None, name=None):
    return apply(float_args(lambda a: torch.linalg.cond(a, p)), x,
                 name="cond")


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise ``p``-norm distances of the rows of ``x`` ``[.., M, D]``
    and ``y`` ``[.., N, D]`` (for p = 2 the root of the squared sum, kept
    off 0 at 1e-24 so its gradient is finite)."""
    def f(a, b):
        d = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=1e-24))
        return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)

    return apply(f, x, y, name="cdist")
