"""Operator-form conjugate gradient.

Counterpart of the JAX package's ``linalg/conjgrad.py``. The JAX package
runs each loop as a ``lax.while_loop`` whose stopping test lives on the
device; here each loop is a Python loop that reads its stopping flag to
the host once an iteration (one synchronization an iteration on a CUDA
tensor) and computes the same iterates.

Status codes of :func:`conjgrad`:
    0: absolute tolerance reached
    1: relative tolerance reached
    2: curvature has converged
    3: curvature is negative
    4: maximum iterations reached
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.ops.common import (INNER_ITERATIONS, matmul, row_dot,
                                        safe_div)

STATUS_MESSAGES = {
    0: "Absolute tolerance reached.",
    1: "Relative tolerance reached.",
    2: "Curvature has converged.",
    3: "Curvature is negative.",
    4: "Maximum iterations reached.",
}

_RUNNING = -1


def conjgrad(b, Adot, dot, maxiter=None, tol=1e-10, rtol=1e-1,
             return_status=False, verbose=0):
    """Solve ``A x = b`` for a PSD operator ``A`` given as a matvec closure.

    ``dot(u, v)`` defines the (possibly per-sample, keepdim) inner
    product; the stopping tests sum it over the whole batch. An iteration
    that meets the relative tolerance (checked at its top), a converged
    curvature or a negative one stops with the previous iterate (a
    negative curvature at the first iteration takes the steepest-descent
    step instead); the absolute tolerance keeps the new iterate. The
    status is the first of relative tolerance, converged curvature,
    negative curvature, absolute tolerance that holds.

    ``verbose`` >= 1 prints the terminal status message, > 1 also the
    residual norm of each iteration. Returns ``x``, and with
    ``return_status`` also the status code (an int).
    """
    verbose = int(verbose)
    if maxiter is None:
        maxiter = 20 * (b.numel() if b.ndim == 1 else b[0].numel())

    b_abs = torch.sum(torch.abs(b))
    termcond = rtol * b_abs * torch.clamp(torch.sqrt(b_abs), 0.0, 0.5)
    float_eps = torch.finfo(b.dtype).eps

    x = torch.zeros_like(b)
    r = -b
    p = b
    rs_old = dot(r, r)
    k = 0
    status = _RUNNING
    while status == _RUNNING and k < maxiter:
        INNER_ITERATIONS["conjgrad"] += 1
        rel_done = torch.sum(torch.abs(r)) <= termcond
        Ap = Adot(p)
        curv = dot(p, Ap)
        curv_sum = torch.sum(curv)
        curv_conv = (curv_sum >= 0) & (curv_sum <= 3 * float_eps)
        curv_neg = curv_sum < 0

        alpha = safe_div(rs_old, curv)
        x_new = x + alpha * p
        r_new = r + alpha * Ap
        rs_new = dot(r_new, r_new)
        abs_done = torch.sqrt(torch.sum(rs_new)) < tol
        code = torch.where(
            rel_done, 1, torch.where(
                curv_conv, 2, torch.where(
                    curv_neg, 3, torch.where(abs_done, 0, _RUNNING))))
        status, neg = torch.stack(
            [code, curv_neg.to(code.dtype)]).tolist()       # host sync
        if verbose > 1:
            print(f"iter: {k} - rs: "
                  f"{float(torch.sqrt(torch.sum(rs_new))):.4f}")
        if status in (1, 2, 3):
            if neg and k == 0:
                # steepest-descent fallback on a first-iteration
                # negative curvature (also where the relative tolerance
                # holds too)
                x = -alpha * b
        else:
            beta = safe_div(rs_new, rs_old)
            x, r, p, rs_old = x_new, r_new, -r_new + beta * p, rs_new
        k += 1
    if status == _RUNNING:
        status = 4
    if verbose:
        print("CG: " + STATUS_MESSAGES[status])
    if return_status:
        return x, status
    return x


def conjgrad_per_row(b, Adot, dot, maxiter, tol, x0=None):
    """Batched CG with per-row stops, for operators PSD per sample.

    ``dot(u, v)`` must return a per-sample keepdim inner product (e.g.
    ``sum(u*v, dim=1, keepdim=True)``). Each row stops on its own
    tolerance (``tol`` on the residual norm, with a floor of 100 eps
    relative to the starting residual), freezes on a non-positive
    curvature or a residual that grew past 1e8 times its start, and
    returns its best-residual iterate, so that one ill-conditioned
    sample can neither poison the batch nor stop the other rows early.

    ``x0`` warm-starts the iteration; the tolerance floor is then
    relative to the warm residual.
    """
    if x0 is None:
        u = torch.zeros_like(b)
        r = -b
    else:
        u = x0
        r = Adot(x0) - b
    rs = dot(r, r)
    eps = torch.finfo(b.dtype).eps
    tol_row = torch.maximum(
        torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2,
        (100 * eps) ** 2 * rs)
    # headroom for CG's non-monotone residual 2-norm; past this the row
    # has truly diverged and is frozen at its best iterate
    rs_blowup = 1e8 * torch.clamp_min(rs, 1.0)
    p = -r
    u_best, rs_best = u, rs
    active = rs > tol_row
    k = 0
    while k < maxiter and bool(torch.any(active)):          # host sync
        INNER_ITERATIONS["conjgrad_per_row"] += 1
        Ap = Adot(p)
        curv = dot(p, Ap)
        step = active & (curv > 0)
        alpha = torch.where(step, rs / torch.where(curv > 0, curv, 1.0), 0.0)
        u = u + alpha * p
        r = r + alpha * Ap
        rs_new = torch.where(step, dot(r, r), rs)
        improved = rs_new < rs_best
        u_best = torch.where(improved, u, u_best)
        rs_best = torch.where(improved, rs_new, rs_best)
        beta = torch.where(step, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = torch.where(step, -r + beta * p, p)
        active = (step & (rs_new > tol_row) & torch.isfinite(rs_new)
                  & (rs_new <= rs_blowup))
        rs = rs_new
        k += 1
    return u_best


def cg(A, b, maxiter=None, tol=1e-10, rtol=1.0, precision=None, **kwargs):
    """Single-vector CG: ``A`` dense [n, n], ``b`` [n]."""
    assert A.ndim == 2 and b.ndim == 1
    if maxiter is None:
        maxiter = 20 * b.shape[0]
    Adot = lambda v: matmul(A, v, precision)
    dot = lambda u, v: torch.sum(u * v)
    return conjgrad(b, Adot, dot, maxiter, tol, rtol, **kwargs)


def batch_cg(A, b, maxiter=None, tol=1e-10, rtol=1.0, precision=None,
             **kwargs):
    """Batched CG with a shared matrix: ``A`` [n, n], ``b`` [B, n].
    Per-sample inner products, batch-global stops."""
    assert A.ndim == 2 and b.ndim == 2
    if maxiter is None:
        maxiter = 20 * b.shape[1]
    Adot = lambda v: matmul(v, A.T, precision)
    return conjgrad(b, Adot, row_dot, maxiter, tol, rtol, **kwargs)


def batch_cg_conv2d(kernel, b, tik=0.0, maxiter=None, tol=1e-10, rtol=1.0,
                    stride=1, padding=0, **kwargs):
    """CG on the conv normal operator ``W^T W + tik I``, where ``W v =
    conv_transpose2d(v, kernel)``: kernel ``[C_z, C_x, kh, kw]``, b ``[B,
    C_z, H, W]``. Per-sample inner products, batch-global stops."""
    from lasso_tpu_torch.conv2d.ops import conv2d, conv_transpose2d

    assert kernel.ndim == 4 and b.ndim == 4
    if maxiter is None:
        maxiter = 20 * b[0].numel()

    def Adot(v):
        Av = conv_transpose2d(v, kernel, stride=stride, padding=padding)
        Av = conv2d(Av, kernel, stride=stride, padding=padding)
        if tik > 0:
            Av = Av + tik * v
        return Av

    def dot(u, v):
        return torch.sum(u * v, dim=(1, 2, 3), keepdim=True)

    return conjgrad(b, Adot, dot, maxiter, tol, rtol, **kwargs)
