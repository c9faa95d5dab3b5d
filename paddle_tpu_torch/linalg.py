"""paddle.linalg namespace (counterpart of paddle_tpu/linalg.py): the
linear algebra ops of ops/linalg.py, and `cond`, the matrix condition
number, which cannot be the top-level `cond` (the control-flow op)."""
from .ops.linalg import (  # noqa: F401
    bmm, mv, norm, vector_norm, matrix_norm, cholesky, cholesky_solve,
    inverse, det, slogdet, svd, qr, lu, eig, eigh, eigvals, eigvalsh,
    solve, triangular_solve, lstsq, matrix_power, matrix_rank, pinv,
    cross, cond, corrcoef, cov, multi_dot, dist,
)

__all__ = [
    "bmm", "mv", "norm", "vector_norm", "matrix_norm", "cholesky",
    "cholesky_solve", "inverse", "det", "slogdet", "svd", "qr", "lu",
    "eig", "eigh", "eigvals", "eigvalsh", "solve", "triangular_solve",
    "lstsq", "matrix_power", "matrix_rank", "pinv", "cross", "cond",
    "corrcoef", "cov", "multi_dot", "dist",
]
