"""Spectral-norm estimation by power iteration.

Counterpart of the JAX package's ``linalg/spectral.py``. The loop runs in
Python and reads the eigenvalue estimate to the host once per iteration
for its convergence test.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.ops.common import matmul


def power_iteration(matvec, v0, maxiter=500, tol=1e-9):
    """Estimate the top eigenvalue of a symmetric PSD operator.

    Runs Rayleigh-quotient power iteration until the eigenvalue estimate
    is relatively converged (``|lam - lam_prev| <= tol * lam``, tested in
    float32 as in the JAX package) or ``maxiter``. Returns ``(eigenvalue,
    eigenvector)``; the eigenvalue is a 0-d tensor on ``v0``'s device.
    """
    v = v0 / (torch.linalg.vector_norm(v0) + 1e-30)
    lam = torch.zeros((), dtype=v0.dtype, device=v0.device)
    lam_h = torch.zeros((), dtype=v0.dtype)
    lam_prev_h = torch.full((), math.inf, dtype=v0.dtype)
    k = 0
    while k < maxiter and bool(torch.abs(lam_h - lam_prev_h) > tol * (
            torch.clamp_min(torch.abs(lam_h), 1e-30))):
        w = matvec(v)
        lam = torch.dot(v, w)
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
        lam_prev_h, lam_h = lam_h, lam.cpu()
        k += 1
    return lam, v


def lipschitz_constant(weight, maxiter=500, tol=1e-9, safety=1e-4, v0=None,
                       generator=None, precision=None):
    """Top eigenvalue of ``W^T W``, the Lipschitz constant of the RSS
    gradient that sets ISTA's step size, inflated by ``1 + safety``
    (power iteration converges from below and FISTA needs
    ``lr <= 1/L``).

    The start vector is ``v0`` when given, else a standard normal draw
    from ``generator`` (seed 0 when that is None too) on ``weight``'s
    device. The JAX package starts from ``jax.random.normal(PRNGKey(0))``,
    whose bits torch cannot reproduce; pass that vector as ``v0`` for a
    like-for-like comparison.
    """
    K = weight.shape[1]
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=weight.device).manual_seed(0)
        v0 = torch.randn(K, generator=generator, dtype=weight.dtype,
                         device=weight.device)
    else:
        v0 = torch.as_tensor(v0, dtype=weight.dtype, device=weight.device)

    def matvec(v):
        Wv = matmul(weight, v[:, None], precision)
        return matmul(Wv.T, weight, precision)[0]

    lam, _ = power_iteration(matvec, v0, maxiter=maxiter, tol=tol)
    return lam * (1.0 + safety)
