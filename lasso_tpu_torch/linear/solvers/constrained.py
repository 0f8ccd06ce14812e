"""Constrained sparse-inference formulations, solved on the device.

Counterpart of the JAX package's ``linear/solvers/constrained.py``:

* ``constr=True``: the constrained form ``min ||z||_1 s.t. 0.5 ||W z -
  x||^2 <= rss_lim`` per sample. The RSS at the lasso solution does not
  decrease with the penalty ``alpha``, so the constrained optimum is found
  by a per-sample bisection on ``alpha`` over warm-started FISTA solves.
* ``constr=False, bound=True``: the penalized form, the lasso itself,
  solved by FISTA.

Every loop has a fixed length: no host synchronization.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.linalg.spectral import lipschitz_constant
from lasso_tpu_torch.ops.common import matmul
from lasso_tpu_torch.ops.shrink import soft_threshold


def _fista_per_sample_alpha(x, weight, alpha, z0, lr, n_iters, prec):
    """FISTA with a per-sample [B, 1] penalty vector."""
    Wt = weight.T
    z, y = z0, z0
    t = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        resid = matmul(y, Wt, prec) - x
        grad = matmul(resid, weight, prec)
        z_next = soft_threshold(y - lr * grad, alpha * lr)
        t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
        y = z_next + ((t - 1) / t_next) * (z_next - z)
        z, t = z_next, t_next
    return z


def constrained_inference(x, weight, z0=None, constr=True, bound=True,
                          alpha=1.0, rss_lim=0.1, fista_iters=200,
                          bisect_iters=25, precision=None):
    """Batched constrained / penalized sparse inference.

    x: [B, D] (or [D]), weight: [D, K] -> z: [B, K] (or [K]).

    Where ``rss_lim`` is below a sample's attainable minimum RSS (an
    undercomplete or rank-deficient W), no bisection midpoint is
    feasible, the bracket collapses to its low end, and the code returned
    is the minimum-RSS FISTA solution at the vanishing penalty
    ``alpha_max * 1e-7``, whose RSS exceeds ``rss_lim``.
    """
    if x.ndim == 1:
        return constrained_inference(
            x[None], weight, None if z0 is None else z0[None], constr,
            bound, alpha, rss_lim, fista_iters, bisect_iters, precision)[0]

    B = x.shape[0]
    K = weight.shape[1]
    if z0 is None:
        z0 = torch.zeros((B, K), dtype=x.dtype, device=x.device)
    lr = 1.0 / lipschitz_constant(weight, precision=precision)

    if not constr:
        if not bound:
            raise NotImplementedError(
                "unbounded & unconstrained optimizer not yet implemented.")
        a = torch.full((B, 1), alpha, dtype=x.dtype, device=x.device)
        return _fista_per_sample_alpha(x, weight, a, z0, lr, fista_iters,
                                       precision)

    def rss(z):
        resid = matmul(z, weight.T, precision) - x
        return 0.5 * torch.sum(torch.square(resid), dim=1, keepdim=True)

    # alpha >= ||W^T x||_inf gives z = 0 and the largest RSS
    alpha_max = torch.amax(torch.abs(matmul(x, weight, precision)), dim=1,
                           keepdim=True) * 1.001                # [B, 1]
    lo = alpha_max * 1e-7
    hi = alpha_max
    # samples whose zero solution already meets the constraint
    trivially_feasible = (0.5 * torch.sum(torch.square(x), dim=1,
                                          keepdim=True) <= rss_lim)
    z = z0
    for _ in range(bisect_iters):
        mid = torch.sqrt(lo * hi)   # geometric: alpha spans decades
        z = _fista_per_sample_alpha(x, weight, mid, z, lr, fista_iters,
                                    precision)
        feasible = rss(z) <= rss_lim
        # the optimum sits at the largest feasible alpha (the smallest l1)
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid)
    # the final solve at the feasible end of the bracket
    z_final = _fista_per_sample_alpha(x, weight, lo, z, lr, fista_iters * 2,
                                      precision)
    return torch.where(trivially_feasible, 0.0, z_final)


# the reference's public name
scipy_inference = constrained_inference
