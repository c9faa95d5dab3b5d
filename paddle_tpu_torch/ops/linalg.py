"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py).

The decompositions go through torch.linalg, as the JAX package's go
through XLA's linalg calls; the products are torch.matmul. bmm and mv
are AMP white-list ops and norm ("p_norm") a black-list one: under
auto_cast their inputs are cast as the JAX package's registry casts
them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp.auto_cast import amp_cast
from ._args import axis_of, tensor_of

__all__ = [
    "bmm", "mv", "norm", "vector_norm", "matrix_norm", "cholesky",
    "cholesky_solve", "inverse", "det", "slogdet", "svd", "qr", "lu", "eig",
    "eigh", "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq",
    "matrix_power", "matrix_rank", "pinv", "cross", "corrcoef",
    "cov", "histogram", "histogramdd", "bincount", "multi_dot", "dist",
]
# "cond" (the matrix condition number) is not star-exported, as in the
# JAX package: the top-level `cond` is the control-flow op
# (ops/control_flow.py); the condition number is paddle_tpu_torch.linalg.cond.


def bmm(x, y, name=None):
    x, y = amp_cast("bmm", tensor_of(x), tensor_of(y))
    return torch.matmul(x, y)


def mv(x, vec, name=None):
    x, vec = amp_cast("mv", tensor_of(x), tensor_of(vec))
    return torch.matmul(x, vec)


def _ord(p):
    return {"inf": float("inf"), "-inf": float("-inf")}.get(p, p) \
        if isinstance(p, str) else p


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """jnp.linalg.norm's semantics: a pair of axes takes a matrix norm;
    no axis takes the Frobenius norm (p None or "fro"), a vector's p-norm
    of a 1-d x or a matrix norm of a 2-d one; one axis a vector p-norm
    (p defaults to 2)."""
    (x,) = amp_cast("p_norm", tensor_of(x))
    axis = axis_of(axis)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, tuple) else 2
    if isinstance(axis, tuple) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=axis, keepdim=keepdim)
    if axis is None and p == "fro":
        return torch.sqrt(torch.sum(torch.square(x)))
    p = _ord(p)
    if axis is None and x.dim() == 2:
        return torch.linalg.matrix_norm(x, ord=p, keepdim=keepdim)
    if axis is None and x.dim() != 1:
        raise ValueError(f"norm of order {p} over no axis takes a 1-d or "
                         f"2-d tensor, got {x.dim()}-d")
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(tensor_of(x), ord=_ord(p),
                                    dim=tuple(axis_of(axis)),
                                    keepdim=keepdim)


def dist(x, y, p=2, name=None):
    d = tensor_of(x) - tensor_of(y)
    if p == 0:
        return torch.sum(d != 0).to(d.dtype)
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """The solution of A out = x with A = y y^T (y lower) or y^T y (y
    upper): two triangular solves, as the JAX op takes them (so y's
    gradient is that of its triangle, as there)."""
    low = y.transpose(-1, -2) if upper else y
    z = torch.linalg.solve_triangular(low, x, upper=False)
    return torch.linalg.solve_triangular(low.transpose(-1, -2), z,
                                         upper=True)


def inverse(x, name=None):
    return torch.linalg.inv(x)


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    """[2, ...]: the sign and the log of |det| stacked, as the JAX op."""
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False, name=None):
    """(u, s, v) with v = vh^T, as Paddle returns it."""
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def qr(x, mode="reduced", name=None):
    """(q, r); r alone in mode "r", as jnp.linalg.qr."""
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def lu(x, pivot=True, get_infos=False, name=None):
    """(the packed LU factors, the 1-based int32 pivots), as the JAX op
    returns lu_factor's (which torch.linalg.lu_factor gives)."""
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, piv.to(torch.int32)


def eig(x, name=None):
    return torch.linalg.eig(x)


def eigh(x, UPLO="L", name=None):
    return torch.linalg.eigh(x, UPLO=UPLO)


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """out with x out = y (x^T out = y when transpose); x triangular."""
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) of min |x sol - y|,
    through the SVD as jnp.linalg.lstsq computes it (on every device:
    torch.linalg.lstsq's drivers differ between the CPU and the card).
    Singular values below rcond * the largest count as zero (rcond
    defaults to eps * max(m, n)); the residuals are |y - x sol|^2 per
    column whatever the rank. driver is taken and unused, as in the JAX
    op."""
    a, b = tensor_of(x), tensor_of(y)
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    elif rcond < 0:
        rcond = float(torch.finfo(a.dtype).eps)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vh.transpose(-1, -2) @ (s_inv * (u.transpose(-1, -2) @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, rank, s


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above tol * the largest (tol defaults to eps *
    max(m, n)); hermitian is taken and unused, as in the JAX op."""
    return torch.linalg.matrix_rank(x, rtol=tol)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; Paddle's default 9 takes the first
    axis of size 3."""
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=axis)


def cond(x, p=None, name=None):
    """The condition number of x in the norm p (None: the 2-norm)."""
    return torch.linalg.cond(x, p=_ord(p))


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of `bins` equal bins over [min, max] (the data's range when
    both are 0), the last bin closed, int64."""
    x = tensor_of(input).to(torch.float32)
    lo, hi = (float(min), float(max)) if (min != 0 or max != 0) else \
        (x.min().item(), x.max().item())
    return torch.histc(x, bins=int(bins), min=lo, max=hi).to(torch.int64)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """numpy's histogramdd on the host, as the JAX op computes it: (hist,
    [edges per dim]) in float32 on x's device."""
    a = tensor_of(x)
    w = None if weights is None else tensor_of(weights).cpu().numpy()
    hist, edges = np.histogramdd(a.detach().cpu().numpy(), bins=bins,
                                 range=ranges, density=density, weights=w)

    def dev(arr):
        return torch.as_tensor(np.asarray(arr, np.float32), device=a.device)
    return dev(hist), [dev(e) for e in edges]


def bincount(x, weights=None, minlength=0, name=None):
    """Counts of each value of the non-negative ints x (weights summed
    instead where given, in their dtype), max(max(x) + 1, minlength)
    long."""
    x = tensor_of(x)
    out = torch.bincount(x, weights=weights, minlength=minlength)
    return out.to(weights.dtype) if weights is not None else out


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))
