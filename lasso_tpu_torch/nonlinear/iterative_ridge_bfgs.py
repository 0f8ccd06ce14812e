"""Iterative ridge with per-sample dense BFGS Hessian approximations.

Counterpart of the JAX package's ``nonlinear/iterative_ridge_bfgs.py``:
each sample carries a ``[K, K]`` BFGS approximation of the smooth term's
Hessian, combined with the iterative-ridge diagonal ``alpha / |x|``, and
the step solves the batch of PD systems with
:func:`~lasso_tpu_torch.linalg.basic.batch_cholesky_solve`: on a CUDA
tensor at K <= 256 in float32 that is one launch of the Cholesky solve
kernel K8 (``csrc/chol.cu`` ``chol_solve``) an iteration, and a batch with
a system that is not PD goes to an LU solve as a whole. The bounded line
search is a golden-section search; each loop reads its stopping test to
the host once an iteration, and the solve its finiteness flag.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.linalg.basic import batch_cholesky_solve
from lasso_tpu_torch.linalg.line_search import golden_section
from lasso_tpu_torch.nonlinear._autodiff import value_and_grad


def _bfgs_update(B, x, g, x_prev, g_prev, first):
    """Batched BFGS rank-2 update with per-sample validity masking: a sample
    with ``|y . s| <= 1e-10`` keeps its matrix. ``B``: ``[B, K, K]``;
    ``first`` (a bool) scales B by ``rho * y . y`` before the update."""
    s = (x - x_prev)[:, :, None]                    # [B, K, 1]
    y = (g - g_prev)[:, :, None]
    st, yt = s.transpose(1, 2), y.transpose(1, 2)
    rho_inv = torch.bmm(yt, s)                      # [B, 1, 1]
    valid = torch.abs(rho_inv) > 1e-10
    rho = torch.where(valid, 1.0 / torch.where(valid, rho_inv, 1.0), 1000.0)
    if first:
        B = B * (rho * torch.bmm(yt, y))
    Bs = torch.bmm(B, s)                            # [B, K, 1]
    sBs = torch.bmm(st, Bs)                         # [B, 1, 1]
    B_new = (B + rho * (y * yt)
             - (Bs * Bs.transpose(1, 2)) / torch.where(sBs == 0, 1.0, sBs))
    return torch.where(valid, B_new, B)


def _ridge_step(x, grad, Bm, alpha, tikhonov, eps):
    """The masked iterative-ridge system's solution d (``x - t d`` is the
    step) and the mask of coordinates held at their value (``|x| <
    eps``)."""
    xmag = torch.abs(x)
    is_zero = xmag < eps
    diag = torch.where(is_zero, 0.0,
                       alpha / torch.where(is_zero, 1.0, xmag))
    rhs = torch.where(is_zero, 0.0, grad + diag * x)
    mask2 = is_zero[:, :, None] | is_zero[:, None, :]
    Bk = torch.where(mask2, 0.0, Bm)
    Bk.diagonal(dim1=1, dim2=2).add_(diag + tikhonov)
    return batch_cholesky_solve(rhs, Bk), is_zero


def _defaults(x0, maxiter, eps):
    if maxiter is None:
        maxiter = x0.shape[1] * 5
    if eps is None:
        eps = torch.finfo(x0.dtype).eps
    return maxiter, eps


def _eye_batch(x0):
    B, K = x0.shape
    return torch.eye(K, dtype=x0.dtype, device=x0.device).repeat(B, 1, 1)


def _irb_per_sample(fun_vec, x0, alpha, lr, xtol, tikhonov, eps,
                    line_search, maxiter, ls_maxiter, return_iters):
    """Per-row iterative-ridge BFGS: ``fun_vec``: ``[B, K] -> [B]`` per-row
    losses; a golden-section step and a ``||dx_i||`` stop a row, frozen
    rows' rank-2 updates rejected by the validity masking (s = 0)."""
    maxiter, eps = _defaults(x0, maxiter, eps)
    B, K = x0.shape
    dtype, device = x0.dtype, x0.device

    def evaluate(x):
        f, g = value_and_grad(fun_vec, x)
        return f + alpha * torch.sum(torch.abs(x), dim=1), g

    x = x0.detach()
    _, grad = evaluate(x)
    t = torch.clamp(lr / (torch.sum(torch.abs(grad), dim=1) + 1e-30), max=lr)
    Bm = _eye_batch(x)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    k = 0
    while k < maxiter and not bool(torch.all(done)):         # host sync
        d, is_zero = _ridge_step(x, grad, Bm, alpha, tikhonov, eps)
        if line_search:
            def line_obj(tt):                                  # [B] -> [B]
                x_new = x - tt[:, None] * d
                return (fun_vec(x_new)
                        + alpha * torch.sum(torch.abs(x_new), dim=1))
            t, _ = golden_section(
                line_obj, torch.zeros((B,), dtype=dtype, device=device),
                torch.full((B,), 10.0, dtype=dtype, device=device),
                maxiter=ls_maxiter)
        x_new = torch.where(done[:, None] | is_zero, x, x - t[:, None] * d)
        delta = torch.linalg.vector_norm(x_new - x, dim=1)           # [B]
        f_new, g_new = evaluate(x_new)
        done = done | (delta <= xtol) | ~torch.isfinite(f_new)
        # frozen rows have s = 0 -> rho_inv = 0 -> update rejected
        Bm = _bfgs_update(Bm, x_new, g_new, x, grad, first=k == 0)
        x, grad = x_new, g_new
        t = torch.full((B,), lr, dtype=dtype, device=device)
        k += 1
    if return_iters:
        return x, torch.full((B,), k, device=device)
    return x


@torch.no_grad()
def iterative_ridge_bfgs(f, x0, alpha=1.0, lr=1.0, xtol=1e-5, tikhonov=1e-4,
                         eps=None, line_search=True, maxiter=None,
                         ls_maxiter=30, per_sample=False, verbose=0,
                         return_iters=False):
    """Nonlinear iterative ridge with BFGS on the device of ``x0``
    (``[B, K]``).

    ``f``: a torch callable ``x -> scalar`` smooth loss. Each iteration
    masks the coordinates with ``|x| < eps`` (default: the dtype's eps),
    solves ``(B_k + diag(alpha / |x|) + tikhonov I) d = grad + alpha
    sign(x)`` per sample, and steps ``x - t d``, t by golden section on
    [0, 10] (``ls_maxiter`` trials) or ``lr`` without ``line_search``.
    ``maxiter`` defaults to 5 K. ``per_sample=True`` gives each row its own
    step and ``||dx||`` stop (converged rows freeze); ``f`` must then map
    ``[B, K] -> [B]`` per-row losses. ``verbose`` >= 1 prints the initial
    and final loss and the iterations, > 1 also the loss and ``||dx||``
    each iteration (batch mode).

    Returns ``x``, and with ``return_iters=True`` also the iterations run
    (an int; per-sample mode a ``[B]`` tensor of the shared count).
    """
    verbose = int(verbose)
    assert x0.ndim == 2
    if x0.is_cuda:
        require_fp32_matmul()
    if per_sample:
        return _irb_per_sample(f, x0, alpha, lr, xtol, tikhonov, eps,
                               line_search, maxiter, ls_maxiter,
                               return_iters)
    maxiter, eps = _defaults(x0, maxiter, eps)

    def evaluate(x):
        fval, g = value_and_grad(f, x)
        return fval + alpha * torch.sum(torch.abs(x)), g

    x = x0.detach()
    fval, grad = evaluate(x)
    t = torch.clamp(lr / (torch.sum(torch.abs(grad)) + 1e-30), max=lr)
    Bm = _eye_batch(x)
    if verbose:
        print(f"initial loss: {float(fval):.4f}")
    k, done = 0, False
    while not done and k < maxiter:
        d, is_zero = _ridge_step(x, grad, Bm, alpha, tikhonov, eps)
        if line_search:
            def line_obj(tt):
                x_new = x - tt * d
                return f(x_new) + alpha * torch.sum(torch.abs(x_new))
            t, _ = golden_section(line_obj, x.new_zeros(()), 10.0,
                                  maxiter=ls_maxiter)
        x_new = torch.where(is_zero, x, x - t * d)
        delta = torch.linalg.vector_norm(x_new - x)
        fval, g_new = evaluate(x_new)
        if verbose > 1:
            print(f"iter {k + 1} - loss: {float(fval):.4f} - dx: "
                  f"{float(delta):.4e}")
        delta_h, f_h = torch.stack([delta, fval]).tolist()      # host sync
        done = delta_h <= xtol or not math.isfinite(f_h)
        Bm = _bfgs_update(Bm, x_new, g_new, x, grad, first=k == 0)
        x, grad = x_new, g_new
        t = torch.tensor(lr, dtype=x.dtype)
        k += 1
    if verbose:
        print(f"         Current function value: {float(fval)}\n"
              f"         Iterations: {k}")
    if return_iters:
        return x, k
    return x
