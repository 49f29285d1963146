"""Linear algebra ops of the PyTorch port.

Counterpart of ``paddle_tpu/ops/linalg.py``. ``matmul`` casts two
operands of different dtypes to their promoted type first, as
``jnp.matmul`` does (a bfloat16 operand times a float32 one is a float32
product); ``torch.matmul`` would refuse them. The decompositions are
``torch.linalg``'s (LAPACK on the CPU, cuSOLVER / MAGMA on the card), with
the reference's outputs: ``slogdet`` stacks (sign, log|det|), ``lu`` gives
the packed factors and 1-based int32 pivots, ``lstsq`` (solution,
residuals, rank, singular values), ``eig`` / ``eigvals`` complex64.
"""
from __future__ import annotations

import torch

from ._util import call, op
from .dispatch import OP_REGISTRY, apply_op

__all__ = ["matmul", "mm", "bmm", "dot", "mv", "einsum", "norm", "cross",
           "t", "cholesky", "inverse", "pinv", "det", "slogdet",
           "matrix_power", "matrix_rank", "qr", "svd", "eigh", "eig",
           "eigvalsh", "solve", "triangular_solve", "cholesky_solve",
           "lstsq", "lu", "lu_unpack", "eigvals", "cond", "inv",
           "corrcoef", "cov", "histogram", "matrix_transpose"]


def _promoted(x, y):
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y (x's or y's last two axes swapped first with
    ``transpose_x`` / ``transpose_y``)."""
    return apply_op("matmul", _matmul, x, y, transpose_x=transpose_x,
                    transpose_y=transpose_y)


matmul.op_name = "matmul"
OP_REGISTRY["matmul"] = matmul


def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(*_promoted(x, y))


@op("mm")
def mm(x, y):
    return torch.matmul(*_promoted(x, y))


@op("bmm")
def bmm(x, y):
    return torch.matmul(*_promoted(x, y))


@op("dot")
def dot(x, y):
    return torch.sum(x * y, -1)


@op("mv")
def mv(x, vec):
    return torch.matmul(*_promoted(x, vec))


def einsum(equation, *operands):
    return call("einsum", lambda *ops: torch.einsum(equation, *ops),
                *operands)


def _is_inf(p, sign):
    return isinstance(p, (int, float)) and p == sign * float("inf")


@op("norm")
def norm(x, p="fro", axis=None, keepdim=False):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        if isinstance(axis, (list, tuple)):
            return torch.linalg.matrix_norm(x, "fro", ax, keepdim)
        return torch.linalg.vector_norm(x, 2, ax, keepdim)
    red = ax if ax is not None else tuple(range(x.dim()))
    if _is_inf(p, 1):
        return torch.amax(torch.abs(x), red, keepdim)
    if _is_inf(p, -1):
        return torch.amin(torch.abs(x), red, keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), red, keepdim)
    return torch.sum(torch.abs(x) ** p, red, keepdim) ** (1.0 / p)


@op("cross")
def cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=int(axis) if axis is not None
                              else -1)


@op("t")
def t(x):
    return x.permute(list(range(x.dim()))[::-1])


@op("cholesky")
def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


@op("inverse")
def inverse(x):
    return torch.linalg.inv(x)


@op("pinv")
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@op("det")
def det(x):
    return torch.linalg.det(x)


@op("slogdet")
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@op("matrix_power")
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


@op("matrix_rank", nondiff=True)
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


def qr(x, mode="reduced"):
    return call("qr", lambda a: tuple(torch.linalg.qr(a, mode)), x)


def svd(x, full_matrices=False):
    return call("svd", lambda a: tuple(
        torch.linalg.svd(a, full_matrices=full_matrices)), x)


def eigh(x, UPLO="L"):
    return call("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO)), x)


def _real_if_real(ts):
    """numpy's rule, which the reference's host ``eig`` follows: real
    outputs when every eigenvalue is real."""
    if bool((ts[0].imag == 0).all()):
        return tuple(t.real for t in ts)
    return ts


def eig(x):
    return call("eig", lambda a: _real_if_real(tuple(torch.linalg.eig(a))),
                x, nondiff=True)


@op("eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO)


@op("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


@op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@op("cholesky_solve")
def cholesky_solve(x, y, upper=False):
    # the factor's other triangle is not read, and gets no gradient
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper)


def lstsq(x, y, rcond=None, driver=None):
    def fn(a, b):
        drv = driver or ("gelsd" if a.device.type == "cpu" else "gels")
        return tuple(torch.linalg.lstsq(a, b, rcond, driver=drv))
    return call("lstsq", fn, x, y, nondiff=True)


def lu(x, pivot=True):
    """Packed LU factors and 1-based int32 pivots."""
    return call("lu", lambda a: tuple(torch.linalg.lu_factor(a)), x,
                nondiff=True)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) with A = P @ L @ U from packed factors and pivots."""
    return call("lu_unpack", lambda a, p: tuple(torch.lu_unpack(a, p)), x,
                y, nondiff=True)


def eigvals(x):
    return call("eigvals", lambda a: _real_if_real(
        (torch.linalg.eigvals(a),))[0], x, nondiff=True)


def cond(x, p=None):
    """The condition number of ``x`` under the norm ``p``."""
    return call("cond", lambda a: torch.linalg.cond(a, p), x)


inv = inverse


@op("corrcoef")
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.T)


@op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@op("histogram", nondiff=True)
def histogram(input, bins=100, min=0, max=0):
    lo, hi = (input.min(), input.max()) if (min == 0 and max == 0) \
        else (min, max)
    return torch.histc(input.float(), int(bins), float(lo), float(hi))


@op("matrix_transpose")
def matrix_transpose(x):
    return torch.swapaxes(x, -1, -2)
