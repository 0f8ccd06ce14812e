"""Iterated ridge regression (Fan & Li approximation) for the lasso.

Counterpart of the JAX package's ``linear/solvers/iterative_ridge.py``:
approximate ``||z||_1 ~ z^2/|z|`` and solve a sequence of ridge
subproblems with diagonal weights ``alpha/|z_k|``, freezing coordinates
that hit zero. The subproblem is solved by CG on the K-system
(``cg=True``), by the Woodbury identity on a D-system (CG, or the batched
Cholesky solve, kernel K8 on a CUDA tensor at D <= 256), or by the batched
Cholesky solve of the dense [B, K, K] system; the step length comes from
a golden-section search over a precomputed residual decomposition. The
outer loop reads its stopping flag to the host once an iteration.
"""

from __future__ import annotations

import warnings

import torch

from lasso_tpu_torch.linalg.basic import batch_cholesky_solve
from lasso_tpu_torch.linalg.conjgrad import conjgrad
from lasso_tpu_torch.linalg.line_search import golden_section
from lasso_tpu_torch.ops.common import matmul, row_dot, weighted_gram


def iterative_ridge(z0, x, weight, alpha=1.0, tol=1e-5, tikhonov=1e-4,
                    eps=None, maxiter=10, line_search=True, cg=False,
                    cg_options=None, ls_maxiter=30, per_sample_ls=False,
                    woodbury="auto", woodbury_solver="cg",
                    woodbury_cg_iters=None, precision=None,
                    verbose=False, return_iters=False):
    """Iterated ridge. z0: [B, K] (the ridge init is the default of
    ``sparse_encode``), x: [B, D], weight: [D, K].

    ``per_sample_ls=True`` gives each sample its own step length (the
    golden-section trials are elementwise either way).

    ``woodbury``: each per-sample system ``(diag(d) + (mW)^T (mW)) u = r``
    of size K becomes, by the Woodbury identity, a D-sized solve
    ``u = q - (m/d) * (W^T C^{-1} W q)`` with ``C = I_D + W diag(m/d)
    W^T``, whose weights ``m/d`` are bounded by ``1/tikhonov``.
    ``woodbury_solver='cg'`` (default) solves it matrix-free
    (``woodbury_cg_iters`` iterations at most, default ``min(2D, 256)``,
    relative tolerance 1e-6); ``'cholesky'`` builds the [B, D, D] C and
    calls :func:`batch_cholesky_solve`. 'auto' takes Woodbury when D < K
    and ``cg=False``; True/False force it (True conflicts with
    ``cg=True``).

    Returns ``z``, and with ``return_iters`` also the number of
    iterations executed (an int).
    """
    if tikhonov < 1e-5:
        warnings.warn("small regularization value %0.4e may lead to "
                      "imprecise results." % tikhonov)
    if cg and woodbury is True:
        raise ValueError("cg=True and woodbury=True are mutually exclusive "
                         "subproblem solvers; pick one.")
    if cg and cg_options is None:
        cg_options = {}
    if eps is None:
        eps = float(torch.finfo(weight.dtype).eps)
    tol_total = z0.numel() * tol
    D_feat, K = weight.shape
    use_woodbury = (not cg) and (
        woodbury is True or (woodbury == "auto" and D_feat < K))
    if use_woodbury and woodbury_solver not in ("cg", "cholesky"):
        raise ValueError(f"woodbury_solver must be 'cg' or 'cholesky', got "
                         f"{woodbury_solver!r}")
    Wt = weight.T

    def f(z):
        x_hat = matmul(z, Wt, precision)
        return (0.5 * torch.sum(torch.square(x_hat - x))
                + alpha * torch.sum(torch.abs(z)))

    # rhs of the RSS normal equations and the shared Gram matrix
    rhs = matmul(x, weight, precision)                   # [B, K]
    A = matmul(Wt, weight, precision)                    # [K, K]
    zero_lo = torch.zeros((), dtype=torch.get_default_dtype(),
                          device=x.device)

    z = z0
    k = 0
    done = False
    while not done and k < maxiter:
        zmag = torch.abs(z)
        is_zero = zmag < eps
        diag = torch.where(is_zero, 0.0,
                           alpha / torch.where(is_zero, 1.0, zmag))
        rhs_k = torch.where(is_zero, 0.0, rhs)

        if cg:
            def Adot(v):
                Av = matmul(torch.where(is_zero, 0.0, v), A, precision)
                Av = torch.where(is_zero, 0.0, Av)
                return Av + (diag + tikhonov) * v
            z_sol = conjgrad(rhs_k, Adot, row_dot, **cg_options)
        elif use_woodbury:
            d_all = diag + tikhonov                      # [B, K]
            md = torch.where(is_zero, 0.0, 1.0 / d_all)  # m / d
            q = rhs_k / d_all                            # D^{-1} r
            t1 = matmul(torch.where(is_zero, 0.0, q), Wt, precision)
            if woodbury_solver == "cg":
                # C v = v + W ((m/d) * (W^T v)): C's spectrum lies in
                # [1, 1 + lam_max(W diag(m/d) W^T)]
                def Cdot(v):
                    t = matmul(v, weight, precision) * md
                    return v + matmul(t, Wt, precision)
                iters = (woodbury_cg_iters if woodbury_cg_iters is not None
                         else min(2 * D_feat, 256))
                s = conjgrad(t1, Cdot, row_dot, maxiter=iters, tol=0.0,
                             rtol=1e-6)
            else:
                # C = I_D + W diag(m/d) W^T per sample  [B, D, D]
                C = weighted_gram(weight, md, precision)
                C = C + torch.eye(D_feat, dtype=C.dtype, device=C.device)
                s = batch_cholesky_solve(t1, C)          # [B, D]
            z_sol = q - md * matmul(s, weight, precision)
        else:
            mask2 = is_zero[:, :, None] | is_zero[:, None, :]
            A_k = torch.where(mask2, 0.0, A[None, :, :])
            A_k = A_k + torch.diag_embed(diag + tikhonov)
            z_sol = batch_cholesky_solve(rhs_k, A_k)     # [B, K]

        if line_search:
            p = z_sol - z
            # the residual decomposition: each trial t is elementwise
            R0 = matmul(z, Wt, precision) - x
            Rp = matmul(p, Wt, precision)
            if per_sample_ls:
                def line_obj(t):  # [B] -> [B]
                    tt = t[:, None]
                    return (0.5 * torch.sum(torch.square(R0 + tt * Rp), 1)
                            + alpha * torch.sum(torch.abs(z + tt * p), 1))

                t, fvals = golden_section(
                    line_obj, torch.zeros((z.shape[0],), dtype=z.dtype,
                                          device=z.device),
                    10.0, maxiter=ls_maxiter)
                t = t[:, None]
                fval_new = torch.sum(fvals)
            else:
                def line_obj(t):
                    return (0.5 * torch.sum(torch.square(R0 + t * Rp))
                            + alpha * torch.sum(torch.abs(z + t * p)))

                t, fval_new = golden_section(line_obj, zero_lo, 10.0,
                                             maxiter=ls_maxiter)
            update = p * t
            z_new = torch.where(is_zero, z, z + update)
        else:
            update = z_sol - z
            z_new = torch.where(is_zero, z, z_sol)
            fval_new = f(z_new)

        if verbose:
            print(f"iter {k} - fval: {float(fval_new):.4f}")
        stop = ((torch.sum(torch.abs(update)) <= tol_total)
                | torch.isnan(fval_new) | torch.any(torch.isnan(update)))
        z = z_new
        k += 1
        done = bool(stop)                                   # host sync
    if return_iters:
        return z, k
    return z
