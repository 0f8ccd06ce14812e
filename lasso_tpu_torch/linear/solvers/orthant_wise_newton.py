"""Orthant-wise Newton with the exact RSS Hessian inverse.

Counterpart of the JAX package's ``linear/solvers/orthant_wise_newton.py``:
OWL-QN specialized to the linear case, where the inverse Hessian
``(W^T W + 1e-4 I)^{-1}`` is precomputed exactly. The orthant projection
zeroes sign-inconsistent coordinates; the pseudo-gradient takes the
steeper one-sided subgradient at zeros. The step length comes from a
golden-section search ('brent'; each trial costs one product, since the
projection makes the objective piecewise in t), a backtracking search, or
is fixed. The loop reads its stopping flag to the host once an iteration.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.linalg.basic import cholesky_inverse
from lasso_tpu_torch.linalg.line_search import golden_section
from lasso_tpu_torch.ops.common import INNER_ITERATIONS, matmul


def project(u, v):
    """Zero the entries of u whose sign disagrees with v."""
    return torch.where(torch.sign(u) != torch.sign(v), 0.0, u)


def pseudo_grad(z, grad_f, alpha):
    """The orthant-wise pseudo-gradient."""
    grad_r = alpha * torch.sign(z)
    at_zero = z == 0
    grad_right = grad_f + torch.where(at_zero, alpha, grad_r)
    grad_left = grad_f + torch.where(at_zero, -alpha, grad_r)
    pgrad = torch.zeros_like(z)
    pgrad = torch.where(grad_right < 0, grad_right, pgrad)
    pgrad = torch.where(grad_left > 0, grad_left, pgrad)
    return pgrad


def orthant_wise_newton(weight, x, z0, alpha=1.0, lr=1.0, maxiter=20,
                        xtol=1e-5, line_search="brent", ls_options=None,
                        ls_maxiter=30, per_sample_ls=False, precision=None,
                        verbose=0, return_iters=False):
    """Orthant-wise Newton. weight: [D, K], x: [B, D], z0: [B, K] -> z.

    ``line_search``: 'brent' (a golden-section search on [0, 10] of
    ``ls_maxiter`` reductions; ``per_sample_ls=True`` gives each sample
    its own step), 'backtrack' (from ``lr``, ``ls_options`` 'tol' 0.1,
    'decay' 0.95, 'maxiter' 500) or 'none' (the step ``lr``). The loop
    stops when a step moves z by at most ``xtol``.

    ``verbose`` >= 1 prints the initial and final objective and the
    iteration count, > 1 also each iteration's objective and step.
    ``return_iters`` also returns the iterations executed (an int).
    """
    verbose = int(verbose)
    assert z0.ndim == 2
    if ls_options is None:
        ls_options = {}
    if line_search not in ("brent", "backtrack", "none"):
        raise ValueError(
            "line_search must be one of {'brent', 'backtrack', 'none'}.")
    ls_tol = ls_options.get("tol", 0.1)
    ls_decay = ls_options.get("decay", 0.95)
    ls_bt_maxiter = ls_options.get("maxiter", 500)
    Wt = weight.T

    def evaluate(z):
        resid = matmul(z, Wt, precision) - x
        f = (0.5 * torch.sum(torch.square(resid))
             + alpha * torch.sum(torch.abs(z)))
        grad = matmul(resid, weight, precision)
        return f, pseudo_grad(z, grad, alpha)

    hess = matmul(Wt, weight, precision)
    hess = hess + 1e-4 * torch.eye(hess.shape[0], dtype=hess.dtype,
                                   device=hess.device)
    hess_inv_t = cholesky_inverse(hess).T
    zero_lo = torch.zeros((), dtype=torch.get_default_dtype(),
                          device=x.device)

    z = z0
    f, g_pseudo = evaluate(z0)
    if verbose:
        print(f"initial f: {float(f):.4f}")
    k = 0
    done = False
    while not done and k < maxiter:
        v = -g_pseudo
        d = project(matmul(v, hess_inv_t, precision), v)
        eta = torch.where(z == 0, torch.sign(v), torch.sign(z))

        def f_at(t, reduce_rows=False):
            z_t = project(z + t * d, eta)
            resid = matmul(z_t, Wt, precision) - x
            if reduce_rows:
                return (0.5 * torch.sum(torch.square(resid), 1)
                        + alpha * torch.sum(torch.abs(z_t), 1))
            return (0.5 * torch.sum(torch.square(resid))
                    + alpha * torch.sum(torch.abs(z_t)))

        if line_search == "brent":
            if per_sample_ls:
                t, _ = golden_section(
                    lambda t: f_at(t[:, None], reduce_rows=True),
                    torch.zeros((z.shape[0],), dtype=z.dtype,
                                device=z.device), 10.0, maxiter=ls_maxiter)
                t = t[:, None]
            else:
                t, _ = golden_section(f_at, zero_lo, 10.0,
                                      maxiter=ls_maxiter)
        elif line_search == "backtrack":
            t = torch.as_tensor(lr, dtype=z.dtype)
            for _ in range(ls_bt_maxiter):
                INNER_ITERATIONS["own_backtrack"] += 1
                z_t = project(z + t * d, eta)
                ok = f_at(t) <= f - ls_tol * torch.sum(v * (z_t - z))
                if bool(ok):                                # host sync
                    break
                t = t * ls_decay
        else:
            t = torch.as_tensor(lr, dtype=z.dtype)

        z_new = project(z + t * d, eta)
        delta = torch.linalg.vector_norm(z_new - z)
        f, g_pseudo = evaluate(z_new)
        z = z_new
        k += 1
        if verbose > 1:
            print(f"iter {k} - f: {float(f):.4f} - dz: {float(delta):.3e}")
        done = bool(delta <= xtol)                          # host sync
    if verbose:
        print(f"         Current function value: {float(f)}\n"
              f"         Iterations: {k}")
    if return_iters:
        return z, k
    return z
