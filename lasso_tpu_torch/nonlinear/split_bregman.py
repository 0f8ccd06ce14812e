"""Gauss-Newton split Bregman for nonlinear residual functions.

Counterpart of the JAX package's ``nonlinear/split_bregman.py``, with its
two inner least-squares solvers:

* ``solver='exact'``: explicit-Jacobian Gauss-Newton, the Jacobian by one
  batched backward pass over the identity's rows, ``mu J^T J + lambd I``
  solved by Cholesky with an LU solve where that gives a non-finite step.
  For a small flattened problem only: J is ``[n_out, n_in]``.
* ``solver='cg'``: matrix-free ``(mu J^T J + lambd I)`` by conjugate
  gradients on Jacobian-vector products, then a golden-section step.

Each loop reads its stopping test to the host once an iteration.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.linalg.basic import cholesky_solve
from lasso_tpu_torch.linalg.conjgrad import conjgrad
from lasso_tpu_torch.linalg.line_search import golden_section
from lasso_tpu_torch.nonlinear._autodiff import linearize
from lasso_tpu_torch.ops.shrink import soft_threshold


def _jacobian(fun, x):
    """``fun(x)`` ([m]) and its Jacobian ``[m, n]`` at x ([n])."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        fv = fun(xx)
        eye = torch.eye(fv.numel(), dtype=fv.dtype, device=fv.device)
        (J,) = torch.autograd.grad(fv, xx, eye, is_grads_batched=True)
    return fv.detach(), J


def _lstsq_exact(fun, x, d, b, max_iter, mu, lambd, lr, xtol):
    """The explicit-Jacobian Gauss-Newton subproblem."""
    eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
    for _ in range(max_iter):
        fv, J = _jacobian(fun, x)
        grad = mu * (J.T @ fv) - lambd * (d - x - b)
        JtJ = mu * (J.T @ J) + lambd * eye
        L, info = torch.linalg.cholesky_ex(JtJ)
        p = cholesky_solve(grad[:, None], L)[:, 0]
        # a failed factorization or a non-finite step: the general solve
        if not bool((info == 0) & torch.isfinite(p).all()):   # host sync
            p = torch.linalg.solve(JtJ, grad)
        x = x - lr * p
        if float(torch.sum(torch.abs(lr * p))) <= xtol:        # host sync
            break
    return x


def _lstsq_cg(fun, x, d, b, max_iter, mu, lambd, lr, xtol, cg_kwargs,
              ls_maxiter=20):
    """The matrix-free Gauss-Newton subproblem."""
    if cg_kwargs is None:
        cg_kwargs = {}

    def obj(u):
        return 0.5 * (mu * torch.sum(torch.square(fun(u)))
                      + lambd * torch.sum(torch.square(d - u - b)))

    for _ in range(max_iter):
        fv, jvp, vjp = linearize(fun, x)
        grad = mu * vjp(fv) - lambd * (d - x - b)

        def JtJ_mv(v):
            return mu * vjp(jvp(v)) + lambd * v

        p = -conjgrad(grad, JtJ_mv, lambda u, v: torch.sum(u * v),
                      **cg_kwargs)
        t, _ = golden_section(lambda t: obj(x + t * p), x.new_zeros(()),
                              2.0 * lr, maxiter=ls_maxiter)
        x = x + t * p
        if float(torch.sum(torch.abs(t * p))) <= xtol:         # host sync
            break
    return x


@torch.no_grad()
def split_bregman_nl(fun, x0, lr=1.0, alpha=1.0, lambd=1.0, tau=1.0,
                     max_iter=None, inner_iter=5, lstsq_iter=5, xtol=1e-5,
                     disp=0, solver="cg", cg_kwargs=None,
                     return_iters=False):
    """Nonlinear split Bregman on the device of ``x0``.

    ``fun``: a torch callable residual ``x -> f(x)`` (any shapes); minimizes
    ``0.5 ||f(x)||^2 + alpha ||x||_1`` over the flattened x, the whole
    batch as one problem. ``max_iter`` (outer Bregman iterations) defaults
    to ``min(n_in, n_out)``; each runs ``inner_iter`` rounds of
    ``lstsq_iter`` Gauss-Newton steps and a shrink. ``cg_kwargs`` go to
    :func:`~lasso_tpu_torch.linalg.conjgrad.conjgrad` under
    ``solver='cg'``. ``disp`` > 1 prints the cost after every outer
    iteration, any true value the final cost.

    Returns ``x`` in x0's shape, and with ``return_iters=True`` also the
    outer iterations run (an int).
    """
    disp = int(disp)
    if x0.is_cuda:
        require_fp32_matmul()
    shape = x0.shape
    x = x0.detach().reshape(-1)

    def fun_flat(u):
        return fun(u.reshape(shape)).reshape(-1)

    f0 = fun_flat(x)
    input_size, output_size = x.numel(), f0.numel()
    xtol_total = input_size * xtol
    if max_iter is None:
        max_iter = min(input_size, output_size)

    def cost_fn(u):
        return (0.5 * torch.sum(torch.square(fun_flat(u)))
                + alpha * torch.sum(torch.abs(u)))

    if solver == "exact":
        def subproblem(x, d, b):
            return _lstsq_exact(fun_flat, x, d, b, lstsq_iter, 1.0 / alpha,
                                lambd, lr, xtol_total)
    elif solver == "cg":
        def subproblem(x, d, b):
            return _lstsq_cg(fun_flat, x, d, b, lstsq_iter, 1.0 / alpha,
                             lambd, lr, xtol_total, cg_kwargs)
    else:
        raise ValueError(
            'Expected `solver` to be one of "exact" or "cg" '
            f"but got {solver}")

    b = torch.zeros_like(x)
    d = torch.zeros_like(x)
    cost = float(cost_fn(x))                                    # host sync
    update, nit = math.inf, 0
    while nit < max_iter and update > xtol_total and math.isfinite(cost):
        x_old = x
        for _ in range(inner_iter):
            x = subproblem(x, d, b)
            d = soft_threshold(x + b, 1.0 / lambd)
        b = b + tau * (x - d)
        update, cost = torch.stack(
            [torch.linalg.vector_norm(x - x_old), cost_fn(x)]).tolist()
        nit += 1
        if disp > 1:
            print(f"iter {nit} - cost: {cost:.4f}")
    if disp:
        print(f"final cost: {cost:.4f}")
    if return_iters:
        return x.reshape(shape), nit
    return x.reshape(shape)
