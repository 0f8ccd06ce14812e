"""Split Bregman for L1-regularized least squares.

Counterpart of the JAX package's ``linear/solvers/split_bregman.py``:
precompute ``(A^T A / alpha + lambd I)^{-1}`` once (a Cholesky inverse),
then alternate a fixed count of inner ridge-solve + shrinkage steps with
an outer Bregman update, in the transposed ``[K, N]`` layout. The outer
loop reads ``||x - x_old|| > tol`` to the host once an iteration; the inner
steps never stop early.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.linalg.basic import cholesky_inverse
from lasso_tpu_torch.ops.common import matmul
from lasso_tpu_torch.ops.precision import round_bf16
from lasso_tpu_torch.ops.shrink import soft_threshold


def split_bregman(A, y, x0=None, alpha=1.0, lambd=1.0, maxiter=20,
                  niter_inner=5, tol=1e-10, tau=1.0, precision=None,
                  kernel_precision="f32", mixed_tail="auto",
                  verbose=False):
    """Split-Bregman lasso.

    A: [D, K] dictionary, y: [N, D] targets -> (x: [N, K], itn: the outer
    iterations executed, an int).

    ``verbose`` prints the cost ``0.5||Ax - y||^2 + alpha||x||_1`` of each
    outer iteration.

    ``kernel_precision``: 'f32' (default; every product at the matmul
    precision), 'bf16' (the inner solve ``AtA_inv @ rhs`` on bf16-rounded
    operands with an f32 sum), or 'mixed' (bf16, then the last
    ``mixed_tail`` outer iterations in f32; 'auto' = max(1, maxiter // 8)).
    """
    assert y.ndim == 2 and A.ndim == 2
    assert y.shape[1] == A.shape[0]
    n_features, n_components = A.shape
    n_samples = y.shape[0]

    yT = y.T                                                   # [D, N]
    if x0 is None:
        x = torch.zeros((n_components, n_samples), dtype=y.dtype,
                        device=y.device)
    else:
        assert tuple(x0.shape) == (n_samples, n_components)
        x = x0.T

    b = torch.zeros_like(x)
    d = torch.zeros_like(x)

    # the normal equations, factored once
    Aty = matmul(A.T, yT, precision) / alpha                   # [K, N]
    AtA = matmul(A.T, A, precision) / alpha
    AtA = AtA + lambd * torch.eye(n_components, dtype=A.dtype,
                                  device=A.device)
    AtA_inv = cholesky_inverse(AtA)

    if kernel_precision not in ("f32", "bf16", "mixed"):
        raise ValueError(f"kernel_precision must be 'f32', 'bf16' or "
                         f"'mixed', got {kernel_precision!r}")
    if mixed_tail != "auto" and kernel_precision != "mixed":
        # a tail without 'mixed' would be silently ignored
        raise ValueError("mixed_tail requires kernel_precision='mixed'")
    if kernel_precision == "mixed":
        if mixed_tail == "auto":
            tail = max(1, maxiter // 8)
        else:
            tail = int(mixed_tail)
            if tail < 1:
                raise ValueError(
                    f"mixed_tail must be >= 1 outer iteration, got "
                    f"{mixed_tail}")
        tail = min(tail, maxiter)
        phases = [("bf16", maxiter - tail), ("f32", maxiter)]
    else:
        phases = [(kernel_precision, maxiter)]
    AtA_inv_b = round_bf16(AtA_inv) if phases[0][0] == "bf16" else None

    itn = 0
    for mode, limit in phases:
        # a bf16 phase's ||x - x_old|| carries bf16 rounding noise: it is
        # dropped, so that the f32 tail always runs
        update = math.inf
        while update > tol and itn < limit:
            x_old = x
            for _ in range(niter_inner):
                rhs = Aty + lambd * (d - b)
                if mode == "bf16":
                    x = matmul(AtA_inv_b, rhs, "default")
                else:
                    x = matmul(AtA_inv, rhs, precision)
                d = soft_threshold(x + b, 1.0 / lambd)
            b = b + tau * (x - d)
            itn += 1
            update = float(torch.linalg.vector_norm(x - x_old))  # host sync
            if verbose:
                cost = (0.5 * torch.sum(torch.square(
                    matmul(A, x, precision) - yT))
                    + alpha * torch.sum(torch.abs(x)))
                print(f"iter {itn} - cost: {float(cost):.4f}")
    return x.T, itn
