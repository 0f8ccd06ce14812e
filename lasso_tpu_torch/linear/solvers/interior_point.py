"""Primal-dual log-barrier interior point (basis pursuit denoising).

Counterpart of the JAX package's ``linear/solvers/interior_point.py``
(Chen et al. 2001 via Schmidt 2005 §2.3): the positive/negative variable
split ``z = [z+, z-]``, Sardy-style initialization from the ridge
estimate, Newton steps on the perturbed KKT system through per-sample
normal equations, fraction-to-boundary step sizes and a per-sample
barrier parameter.

The normal equations ``(W diag(d) W^T + I) d_lambda = rhs`` are solved by
building the [B, D, D] matrix and calling :func:`batch_cholesky_solve`
(kernel K8 on a CUDA tensor at D <= 256), or matrix-free by a
warm-started batched CG. The Newton loop reads its stopping flag to the
host once an iteration, the CG once an iteration of its own.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.linalg.basic import batch_cholesky_solve, ridge
from lasso_tpu_torch.ops.common import (INNER_ITERATIONS, check_axis_name,
                                        matmul, psum, row_dot,
                                        safe_div, weighted_gram)

_INF = float("inf")


def _general_inverse(x, eps=1e-5):
    """Reciprocal with small values zeroed."""
    small = torch.abs(x) < eps
    return torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, x))


def _normal_cg(W, d, b, x0, maxiter, rtol, prec):
    """Matrix-free batched CG on ``(W diag(d_i) W^T + I) x_i = b_i``.

    W: [D, 2K], d: [B, 2K], b/x0: [B, D]. Each iteration is two
    [B, D] x [D, 2K]-class products; the +I term keeps the system PD.
    ``rtol`` is the global relative-residual exit ``sum ||r_i||^2 <=
    rtol^2 * sum ||b_i||^2``. Deliberately unpreconditioned (as mu -> 0
    the weights d spike on the few active coordinates, a low-rank
    perturbation of I that Jacobi scaling mis-handles).
    """
    Wt = W.T

    def Adot(v):
        return matmul(matmul(v, W, prec) * d, Wt, prec) + v

    r = b - Adot(x0)
    rs = row_dot(r, r)
    stop_at = rtol * rtol * torch.sum(torch.square(b))
    x, p = x0, r
    k = 0
    while k < maxiter and bool(torch.sum(rs) > stop_at):   # host sync
        INNER_ITERATIONS["normal_cg"] += 1
        Ap = Adot(p)
        a = safe_div(rs, row_dot(p, Ap))
        x = x + a * p
        r = r - a * Ap
        rs_new = row_dot(r, r)
        p = r + safe_div(rs_new, rs) * p
        rs = rs_new
        k += 1
    return x


def _initialize_params(z0, weight, alpha, prec):
    """Sardy et al. (2000) §2.3 initialization."""
    z0_pn = torch.cat([torch.clamp_min(z0, 0.0), torch.clamp_min(-z0, 0.0)],
                      1)
    weight_pn = torch.cat([weight, -weight], 1)                # [D, 2K]
    z = z0_pn + 0.1
    y = matmul(torch.sign(z0_pn), weight_pn.T, prec)           # [B, D]
    omega = 1.1 * torch.amax(torch.abs(matmul(y, weight, prec)), dim=1,
                             keepdim=True)
    lmbda = alpha * y / torch.clamp_min(omega, 1e-30)          # [B, D]
    s = alpha - matmul(lmbda, weight_pn, prec)                 # [B, 2K]
    return z, lmbda, s, weight_pn


def interior_point(x, weight, z0=None, alpha=1.0, maxiter=20,
                   barrier_init=0.1, tol=1e-2, eps=None, precision=None,
                   per_sample=False, kkt_solver="auto", cg_rtol="forcing",
                   cg_maxiter=None, barrier_schedule="reference",
                   sigma=0.1, axis_name=None, verbose=False,
                   return_iters=False):
    """Interior-point lasso solver.

    x: [B, D], weight: [D, K] -> (z: [B, K], success: a bool tensor), and
    with ``return_iters`` also the Newton iterations executed (an int).

    ``per_sample=True`` stops each sample on its own feasibility and gap
    tests (its state freezes once they pass; ``success`` is then a [B]
    vector) instead of the batch means.

    ``kkt_solver``: 'cholesky' builds the [B, D, D] normal matrix (once
    an iteration; O(B D^2) memory) and calls :func:`batch_cholesky_solve`;
    'cg' solves the same system matrix-free, warm-started from the last
    Newton direction (``cg_maxiter`` iterations at most, default
    ``min(2D, 512)``); 'auto' takes 'cholesky' while the [B, D, D] build
    stays under 1 GB. ``cg_rtol='forcing'`` (default) sets each Newton
    iteration's inner relative tolerance to ``clip(0.1 * gap, 1e-7,
    1e-2)`` of the current batch-mean normalized duality gap; a float pins
    it.

    ``barrier_schedule``: 'reference' (``mu *= 1 - min(beta)``),
    'adaptive' (``mu = sigma <z, s> / (2K)`` per sample) or 'mehrotra'
    (predictor-corrector: an affine solve, the centering ``(mu_aff /
    mu)^3`` per sample, and a corrector whose second-order term is clamped
    to +-10 mu; ``sigma`` is ignored).

    ``eps`` (the small-value cutoff of the slack inverses) defaults to
    1e-5 under 'reference' and under 'mehrotra' in float32, else 1e-8.

    ``axis_name`` (a ``torch.distributed.ProcessGroup`` whose ranks each
    hold rows of one batch): the batch means of the stopping test, of the
    CG forcing term and of the verbose report are all-reduced to the
    means over the whole batch. With ``per_sample=True`` the rows stop on
    their own, and the loop runs until every rank's rows have stopped
    (stopped rows stay frozen), so that all ranks make the same
    collectives.
    """
    check_axis_name(axis_name)
    if barrier_schedule not in ("reference", "adaptive", "mehrotra"):
        raise ValueError(f"barrier_schedule must be 'reference', "
                         f"'adaptive' or 'mehrotra', got "
                         f"{barrier_schedule!r}")
    if eps is None:
        if barrier_schedule == "reference":
            eps = 1e-5
        elif barrier_schedule == "mehrotra" and x.dtype == torch.float32:
            # the predictor drives slacks into the cutoff regime, where
            # d = z/s spikes ~1/eps and an f32 CG breaks down; 1e-5 keeps
            # d within f32-safe conditioning
            eps = 1e-5
        else:
            eps = 1e-8
    prec = precision
    batch_size, input_size = x.shape
    assert weight.ndim == 2 and weight.shape[0] == input_size
    if z0 is None:
        z0 = ridge(x.T, weight, alpha=alpha).T

    if kkt_solver == "auto":
        kkt_solver = ("cholesky" if batch_size * input_size ** 2 * 4
                      <= 2 ** 30 else "cg")
    if kkt_solver not in ("cholesky", "cg"):
        raise ValueError(f"kkt_solver must be 'auto', 'cholesky' or 'cg', "
                         f"got {kkt_solver!r}")
    if cg_maxiter is None:
        cg_maxiter = min(2 * input_size, 512)
    cg_forcing = isinstance(cg_rtol, str)
    if cg_forcing and cg_rtol != "forcing":
        raise ValueError(f"cg_rtol must be a float or 'forcing', got "
                         f"{cg_rtol!r}")

    mu = barrier_init * torch.ones((batch_size, 1), dtype=x.dtype,
                                   device=x.device)
    z, lmbda, s, W = _initialize_params(z0, weight, alpha, prec)
    Wt = W.T
    eye = (torch.eye(input_size, dtype=x.dtype, device=x.device)
           if kkt_solver == "cholesky" else None)
    dl_prev = torch.zeros_like(x)
    done_prev = torch.zeros((batch_size, 1), dtype=torch.bool,
                            device=x.device)
    success = (torch.zeros((batch_size,), dtype=torch.bool, device=x.device)
               if per_sample else torch.zeros((), dtype=torch.bool,
                                              device=x.device))

    def batch_mean(v):
        """Mean over the (possibly shared) whole batch."""
        if axis_name is None:
            return torch.mean(v)
        total = psum(torch.sum(v), axis_name)
        count = psum(torch.tensor(v.shape[0], dtype=v.dtype,
                                  device=v.device), axis_name)
        return total / count

    def ftb(v, dv):
        """Fraction-to-boundary step length, capped at 1."""
        beta = torch.amin(torch.where(dv >= 0, _INF, -v / dv), 1,
                          keepdim=True)
        return torch.clamp_max(beta, 1.0)

    k = 0
    all_done = False
    while not all_done and k < maxiter:
        # KKT residuals
        ra = -matmul(lmbda, W, prec) - s + alpha                 # [B, 2K]
        rb = x - matmul(z, Wt, prec) - lmbda                     # [B, D]
        rc = mu - z * s                                          # [B, 2K]

        # Newton directions
        s_inv = _general_inverse(s, eps)
        d = s_inv * z                                            # [B, 2K]
        if kkt_solver == "cg" and cg_forcing:
            # inexact Newton: the inner target tracks the current
            # normalized duality gap
            gap_cur = batch_mean(
                torch.sum(z * s, dim=1)
                / (1 + torch.linalg.vector_norm(z, dim=1)
                   * torch.linalg.vector_norm(lmbda, dim=1)))
            rtol_k = torch.clamp(0.1 * gap_cur, 1e-7, 1e-2)
        else:
            rtol_k = cg_rtol
        if kkt_solver == "cholesky":
            # M = W diag(d) W^T + I per sample, built once an iteration
            # (both Mehrotra solves share it)
            M = weighted_gram(W, d, prec) + eye

        def directions(rc_vec, warm):
            """Newton directions for a complementarity rhs; the normal
            matrix (d) is fixed within the iteration."""
            rhs = s_inv * rc_vec - d * ra
            rhs = rb - matmul(rhs, Wt, prec)                     # [B, D]
            if kkt_solver == "cholesky":
                d_l = batch_cholesky_solve(rhs, M)               # [B, D]
            else:
                d_l = _normal_cg(W, d, rhs, warm, cg_maxiter, rtol_k,
                                 prec)
            d_sl = ra - matmul(d_l, W, prec)
            d_zc = s_inv * (rc_vec - z * d_sl)
            return d_zc, d_l, d_sl

        if barrier_schedule == "mehrotra":
            # predictor: the pure-Newton (mu = 0) affine step
            dz_aff, dl_aff, ds_aff = directions(-z * s, dl_prev)
            a_z = ftb(z, dz_aff)
            a_s = ftb(s, ds_aff)
            mu_cur = torch.mean(z * s, dim=1, keepdim=True)      # [B, 1]
            mu_aff = torch.mean((z + a_z * dz_aff) * (s + a_s * ds_aff),
                                dim=1, keepdim=True)
            ratio = mu_aff / torch.clamp_min(mu_cur, 1e-30)
            sigma_m = torch.clamp(ratio, 0.0, 1.0) ** 3
            # corrector: center on sigma*mu and cancel the second-order
            # term, clamped to +-10 mu (an inexact inner solve can make it
            # huge for blocked coordinates)
            soc = torch.clamp(dz_aff * ds_aff, -10.0 * mu_cur, 10.0 * mu_cur)
            rc = sigma_m * mu_cur - soc - z * s
            d_z, d_lmbda, d_s = directions(rc, dl_aff)
        else:
            d_z, d_lmbda, d_s = directions(rc, dl_prev)

        # fraction-to-boundary step sizes
        beta_z = ftb(z, d_z)
        beta_sl = ftb(s, d_s)
        z_new = torch.clamp_min(z + 0.99 * beta_z * d_z, 0.0)
        lmbda_new = lmbda + 0.99 * beta_sl * d_lmbda
        s_new = torch.clamp_min(s + 0.99 * beta_sl * d_s, 0.0)

        # a row whose inexact inner solve went non-finite keeps its last
        # good iterate
        row_ok = (torch.isfinite(torch.sum(z_new, dim=1))
                  & torch.isfinite(torch.sum(lmbda_new, dim=1))
                  & torch.isfinite(torch.sum(s_new, dim=1)))[:, None]
        z_new = torch.where(row_ok, z_new, z)
        lmbda_new = torch.where(row_ok, lmbda_new, lmbda)
        s_new = torch.where(row_ok, s_new, s)
        if barrier_schedule == "adaptive":
            mu_new = sigma * (torch.sum(z_new * s_new, dim=1, keepdim=True)
                              / z.shape[1])
        elif barrier_schedule == "mehrotra":
            mu_new = torch.mean(z_new * s_new, dim=1, keepdim=True)
        else:
            mu_new = mu * (1 - torch.clamp_max(
                torch.minimum(beta_z, beta_sl), 0.99))

        # stopping tests: batch means, or per sample
        z_norm = torch.linalg.vector_norm(z_new, dim=1)
        l_norm = torch.linalg.vector_norm(lmbda_new, dim=1)
        prim_i = torch.linalg.vector_norm(rb, dim=1) / (1 + z_norm)
        dual_i = torch.linalg.vector_norm(ra, dim=1) / (1 + l_norm)
        gap_i = torch.sum(z_new * s_new, dim=1) / (1 + z_norm * l_norm)
        if per_sample:
            done_i = done_prev[:, 0] | ((prim_i < tol) & (dual_i < tol)
                                        & (gap_i < tol))         # [B]
            z_new = torch.where(done_prev, z, z_new)
            lmbda_new = torch.where(done_prev, lmbda, lmbda_new)
            s_new = torch.where(done_prev, s, s_new)
            mu_new = torch.where(done_prev, mu, mu_new)
            success = done_i
            stop = torch.all(done_i)
            if axis_name is not None:
                # every rank's rows stopped: the count of ranks not done
                stop = psum((~stop).to(x.dtype), axis_name) == 0
            done_prev = done_i[:, None]
        else:
            success = ((batch_mean(prim_i) < tol)
                       & (batch_mean(dual_i) < tol)
                       & (batch_mean(gap_i) < tol))
            stop = success

        if verbose:
            objf = (alpha * torch.sum(z_new)
                    + 0.5 * torch.sum(torch.square(lmbda_new)))
            print(f"niter {k + 1}  obj {float(objf):.4e}  prim "
                  f"{float(batch_mean(prim_i)):.2e}  dual "
                  f"{float(batch_mean(dual_i)):.2e}  gap "
                  f"{float(batch_mean(gap_i)):.2e}")

        z, lmbda, s, mu, dl_prev = z_new, lmbda_new, s_new, mu_new, d_lmbda
        k += 1
        all_done = bool(stop)                               # host sync

    zf = z[:, :z.shape[1] // 2] - z[:, z.shape[1] // 2:]
    if return_iters:
        return zf, success, k
    return zf, success
