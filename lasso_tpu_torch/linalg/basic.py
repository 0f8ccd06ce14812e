"""Dense linear-algebra helpers.

Counterpart of the JAX package's ``linalg/basic.py``: QR least squares /
least norm, Cholesky ridge, a Cholesky solve, the batched PD solve with
its LU fallback (on the Cholesky solve kernel K8 where it applies), and
the inverse of an SPD matrix.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.batched_cholesky import (batch_cholesky_solve_lanes,
                                                  supports_lanes_cholesky)
from lasso_tpu_torch.ops.common import matmul, resolve_pallas


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


def batch_cholesky_solve(b, A, use_pallas="auto"):
    """Solve a batch of PD systems ``A_s x_s = b_s``.

    b: [B, D], A: [B, D, D] -> x: [B, D]

    Where :func:`supports_lanes_cholesky` holds (float32, D <= 256), on a
    CUDA tensor with ``use_pallas`` 'auto' or True, and on any tensor with
    True (the plain version off the card), the batch goes to
    :func:`batch_cholesky_solve_lanes` (kernel K8); otherwise to
    ``torch.linalg.cholesky_ex`` and two triangular solves, the JAX
    package's own route outside its kernel. On either route, a system that
    is not PD (a non-finite x, or a failed factorization) sends the whole
    batch to an LU solve, as the JAX package's ``lax.cond`` does. Deciding
    that reads one flag to the host: a synchronization a call. On a CUDA
    tensor, ``_cuda.WRAPPER_CALLS`` counts the batches that fell back to LU
    (``batch_cholesky_solve_lu``); K8's own count is its launches.
    """
    assert b.ndim == 2 and A.ndim == 3, (b.shape, A.shape)
    b3 = b[:, :, None]
    if resolve_pallas(use_pallas, supports_lanes_cholesky(b, A), b.device):
        x = batch_cholesky_solve_lanes(b, A)
        ok = bool(torch.isfinite(x).all())           # host sync
    else:
        L, info = torch.linalg.cholesky_ex(A)
        ok = bool(torch.all(info == 0) & torch.isfinite(L).all())  # sync
        x = cholesky_solve(b3, L)[:, :, 0] if ok else None
    if ok:
        return x
    if b.is_cuda:
        _cuda.WRAPPER_CALLS["batch_cholesky_solve_lu"] += 1
    return torch.linalg.solve_ex(A, b3)[0][:, :, 0]


def cholesky_inverse(M):
    """Inverse of an SPD matrix through its Cholesky factor (what the
    reference's split Bregman and orthant-wise Newton precompute with
    ``torch.cholesky_inverse(torch.linalg.cholesky(M))``). A matrix that
    is not PD gives NaNs, as in the JAX package."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return cholesky_solve(eye, L)
