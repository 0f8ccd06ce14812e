"""Dense linear-algebra helpers.

Counterpart of the JAX package's ``linalg/basic.py`` for what
``initialize_code`` needs: QR least squares / least norm, Cholesky
ridge, and a Cholesky solve. ``batch_cholesky_solve`` and
``cholesky_inverse`` come with the interior-point slice.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.ops.common import matmul


def qr(A):
    """Reduced QR factorization."""
    return torch.linalg.qr(A, mode="reduced")


def lstsq(b, A, precision=None):
    """Solve ``A x = b`` by QR: the least-norm solution (QR of ``A^T``)
    for wide ``A`` (m < n), else the least-squares solution.

    b: [..., m, k], A: [..., m, n] -> x: [..., n, k]
    """
    m, n = A.shape[-2:]
    if m < n:
        Q, R = qr(A.transpose(-1, -2))
        d = torch.linalg.solve_triangular(R.transpose(-1, -2), b,
                                          upper=False)
        return matmul(Q, d, precision)
    Q, R = qr(A)
    d = matmul(Q.transpose(-1, -2), b, precision)
    return torch.linalg.solve_triangular(R, d, upper=True)


def ridge(b, A, alpha=1e-4, precision=None):
    """Ridge regression ``(A^T A + alpha I) x = A^T b`` via Cholesky.

    A Gram matrix that is not PD yields NaNs, as in the JAX package.
    """
    At = A.transpose(-1, -2)
    rhs = matmul(At, b, precision)
    M = matmul(At, A, precision)
    M = M + alpha * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    return cholesky_solve(rhs, L)


def cholesky_solve(b, L):
    """Solve ``(L L^T) x = b`` given a lower-triangular Cholesky factor."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
