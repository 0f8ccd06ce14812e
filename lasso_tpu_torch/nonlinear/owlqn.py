"""OWL-QN: orthant-wise limited-memory quasi-Newton for the nonlinear lasso.

Counterpart of the JAX package's ``nonlinear/owlqn.py``. The L-BFGS memory
is a circular buffer of ``[history, numel]`` tensors; its write slot and
fill count live on the host as ints, since the curvature guard of each
update is read to the host anyway (one synchronization an update), and the
two-loop recursion visits only the filled slots. Each optimizer loop reads
its stopping test to the host once an iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.linalg.line_search import (backtracking_armijo,
                                                golden_section)
from lasso_tpu_torch.nonlinear._autodiff import value_and_grad
from lasso_tpu_torch.ops.common import INNER_ITERATIONS


def project(x, y):
    """Zero the entries of x whose sign disagrees with y's."""
    return torch.where(torch.sign(x) != torch.sign(y), 0.0, x)


def pseudo_grad(x, grad_f, alpha):
    """The orthant-wise pseudo-gradient of ``f + alpha ||x||_1``."""
    grad_r = alpha * torch.sign(x)
    at_zero = x == 0
    grad_right = grad_f + torch.where(at_zero, alpha, grad_r)
    grad_left = grad_f + torch.where(at_zero, -alpha, grad_r)
    pgrad = torch.zeros_like(x)
    pgrad = torch.where(grad_right < 0, grad_right, pgrad)
    pgrad = torch.where(grad_left > 0, grad_left, pgrad)
    return pgrad


class LbfgsState(NamedTuple):
    s_hist: torch.Tensor    # [m, n]
    y_hist: torch.Tensor    # [m, n]
    rho: torch.Tensor       # [m]
    h_diag: torch.Tensor    # 0-d
    head: int               # next write slot
    count: int              # number of valid entries
    x_prev: torch.Tensor    # [n]
    g_prev: torch.Tensor    # [n]


def lbfgs_init(x, g, history_size):
    n = x.numel()
    return LbfgsState(
        s_hist=x.new_zeros((history_size, n)),
        y_hist=x.new_zeros((history_size, n)),
        rho=x.new_zeros((history_size,)),
        h_diag=x.new_ones(()),
        head=0,
        count=0,
        x_prev=x.reshape(-1),
        g_prev=g.reshape(-1),
    )


def lbfgs_solve(state, d):
    """The two-loop recursion over the filled slots, newest first."""
    m = state.s_hist.shape[0]
    q = d.reshape(-1)
    slots = [(state.head - 1 - i) % m for i in range(state.count)]
    alphas = {}
    for idx in slots:
        a = state.rho[idx] * torch.dot(state.s_hist[idx], q)
        q = q - a * state.y_hist[idx]
        alphas[idx] = a
    q = q * state.h_diag
    for idx in reversed(slots):
        b = state.rho[idx] * torch.dot(state.y_hist[idx], q)
        q = q + (alphas[idx] - b) * state.s_hist[idx]
    return q.reshape(d.shape)


def lbfgs_update(state, x, g):
    """The curvature-guarded memory update (``y . s > 1e-10``; one host
    read). An accepted pair is written into the state's buffers in place,
    and the returned state shares them."""
    s = x.reshape(-1) - state.x_prev
    y = g.reshape(-1) - state.g_prev
    rho_inv = torch.dot(y, s)
    if not bool(rho_inv > 1e-10):                            # host sync
        return state
    head, m = state.head, state.s_hist.shape[0]
    state.s_hist[head] = s
    state.y_hist[head] = y
    state.rho[head] = 1.0 / rho_inv
    return state._replace(
        h_diag=rho_inv / (torch.dot(y, y) + 1e-30),
        head=(head + 1) % m,
        count=min(state.count + 1, m),
        x_prev=x.reshape(-1),
        g_prev=g.reshape(-1))


def _backtrack_rows(f_at, slope_at, f, t, ls_tol, ls_decay, maxiter):
    """Per-row Armijo backtracking: each row shrinks its own step ``t``
    ([B]) by ``ls_decay`` until ``f_at(t) <= f - ls_tol * slope_at(t)``
    holds for it; accepted rows keep their step. One host read a trial."""
    ok = torch.zeros_like(t, dtype=torch.bool)
    j = 0
    while j < maxiter and not bool(torch.all(ok)):           # host sync
        INNER_ITERATIONS["backtracking_rows"] += 1
        ok = ok | (f_at(t) <= f - ls_tol * slope_at(t))
        t = torch.where(ok, t, t * ls_decay)
        j += 1
    return t


def _owlqn_per_sample(fun_vec, x0, alpha, lr, max_iter, xtol,
                      history_size, ls_maxiter, return_iters,
                      line_search="brent", ls_options=None):
    """Per-row OWL-QN: a batched L-BFGS whose reductions are per row.

    ``fun_vec``: ``[B, K] -> [B]`` per-row smooth losses. Rejected curvature
    pairs and frozen rows write inert slots (s = y = 0, rho = 0: no-ops in
    the two-loop recursion), so the buffer's head and count stay the same
    for every row.
    """
    if ls_options is None:
        ls_options = {}
    ls_tol = ls_options.get("tol", 0.1)
    ls_decay = ls_options.get("decay", 0.95)
    ls_bt_maxiter = ls_options.get("maxiter", 500)
    B, K = x0.shape
    m = history_size
    dtype, device = x0.dtype, x0.device

    def evaluate(x):
        f, g = value_and_grad(fun_vec, x)
        f = f + alpha * torch.sum(torch.abs(x), dim=1)
        return f, g, pseudo_grad(x, g, alpha)

    def solve(d):
        q = d
        slots = [(head - 1 - i) % m for i in range(count)]
        alphas = {}
        for idx in slots:
            a = rho[idx] * torch.sum(s_hist[idx] * q, dim=1)        # [B]
            q = q - a[:, None] * y_hist[idx]
            alphas[idx] = a
        q = q * h_diag[:, None]
        for idx in reversed(slots):
            b = rho[idx] * torch.sum(y_hist[idx] * q, dim=1)        # [B]
            q = q + (alphas[idx] - b)[:, None] * s_hist[idx]
        return q

    x = x0.detach()
    f, g, gp = evaluate(x)
    s_hist = x.new_zeros((m, B, K))
    y_hist = x.new_zeros((m, B, K))
    rho = x.new_zeros((m, B))
    h_diag = x.new_ones((B,))
    head = count = k = 0
    x_prev, g_prev = x, g
    # per-row first step
    t_init = torch.clamp(lr / (torch.sum(torch.abs(gp), dim=1) + 1e-30),
                         max=lr).to(dtype)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    while k < max_iter and not bool(torch.all(done)):        # host sync
        v = -gp
        d = project(solve(v), v)
        eta = torch.where(x == 0, torch.sign(v), torch.sign(x))

        def x_at(t):
            return project(x + t[:, None] * d, eta)

        def f_at(t):                                         # [B] -> [B]
            x_new = x_at(t)
            return fun_vec(x_new) + alpha * torch.sum(torch.abs(x_new), dim=1)

        if line_search == "brent":
            t, _ = golden_section(
                f_at, torch.zeros((B,), dtype=dtype, device=device),
                torch.full((B,), 10.0, dtype=dtype, device=device),
                maxiter=ls_maxiter)
        elif line_search == "backtrack":
            t = _backtrack_rows(
                f_at, lambda t: torch.sum(v * (x_at(t) - x), dim=1), f,
                t_init, ls_tol, ls_decay, ls_bt_maxiter)
        else:   # 'none': the per-row first step, then lr
            t = t_init

        x_new = torch.where(done[:, None], x, x_at(t))
        delta = torch.linalg.vector_norm(x_new - x, dim=1)         # [B]
        f, g_new, gp = evaluate(x_new)
        done = done | (delta <= xtol)

        # the curvature-guarded per-row write; frozen rows have s = 0 and
        # are rejected
        s = x_new - x_prev
        y = g_new - g_prev
        rho_inv = torch.sum(y * s, dim=1)                          # [B]
        ok = rho_inv > 1e-10
        s_hist[head] = torch.where(ok[:, None], s, 0.0)
        y_hist[head] = torch.where(ok[:, None], y, 0.0)
        rho[head] = torch.where(
            ok, 1.0 / torch.where(ok, rho_inv, 1.0), 0.0)
        h_diag = torch.where(
            ok, rho_inv / (torch.sum(y * y, dim=1) + 1e-30), h_diag)
        x_prev = torch.where(ok[:, None], x_new, x_prev)
        g_prev = torch.where(ok[:, None], g_new, g_prev)
        head, count = (head + 1) % m, min(count + 1, m)
        x, g = x_new, g_new
        t_init = torch.full((B,), lr, dtype=dtype, device=device)
        k += 1
    if return_iters:
        # the shared loop count, a row each (rows freeze in place)
        return x, torch.full((B,), k, device=device)
    return x


@torch.no_grad()
def owlqn(fun, x0, alpha=1.0, lr=1.0, max_iter=20, xtol=1e-5,
          history_size=100, line_search="brent", ls_options=None,
          ls_maxiter=30, per_sample=False, verbose=0, return_iters=False):
    """OWL-QN on the device of ``x0`` (``[B, K]``).

    ``fun``: a torch callable ``x -> scalar`` smooth loss (the l1 term is
    added here and kept out of the gradients). ``per_sample=True`` solves
    every row on its own, with its own ``[history, K]`` memory, line-search
    step and ``||dx||`` stop (converged rows freeze); ``fun`` must then map
    ``[B, K] -> [B]`` per-row losses. The line searches: ``'brent'``
    (golden section on [0, 10], ``ls_maxiter`` trials), ``'backtrack'``
    (Armijo; ``ls_options`` ``tol`` 0.1, ``decay`` 0.95, ``maxiter`` 500)
    and ``'none'``. ``verbose`` >= 1 prints the initial and final f and the
    iterations, > 1 also f and ``||dx||`` each iteration (batch mode).

    Returns ``x``, and with ``return_iters=True`` also the iterations run
    (an int; per-sample mode a ``[B]`` tensor of the shared count).
    """
    verbose = int(verbose)
    assert x0.ndim == 2
    if line_search not in ("brent", "backtrack", "none"):
        raise ValueError("invalid line_search")
    if x0.is_cuda:
        require_fp32_matmul()
    if per_sample:
        return _owlqn_per_sample(fun, x0, alpha, lr, max_iter, xtol,
                                 history_size, ls_maxiter, return_iters,
                                 line_search=line_search,
                                 ls_options=ls_options)
    if ls_options is None:
        ls_options = {}
    ls_tol = ls_options.get("tol", 0.1)
    ls_decay = ls_options.get("decay", 0.95)
    ls_bt_maxiter = ls_options.get("maxiter", 500)

    def evaluate(x):
        f, g = value_and_grad(fun, x)
        f = f + alpha * torch.sum(torch.abs(x))
        return f, g, pseudo_grad(x, g, alpha)

    x = x0.detach()
    f, g, gp = evaluate(x)
    lb = lbfgs_init(x, g, history_size)
    t_init = torch.clamp(lr / (torch.sum(torch.abs(gp)) + 1e-30), max=lr)
    if verbose:
        print(f"initial f: {float(f):.4f}")
    k, done = 0, False
    while not done and k < max_iter:
        v = -gp
        d = project(lbfgs_solve(lb, v), v)
        eta = torch.where(x == 0, torch.sign(v), torch.sign(x))

        def x_at(t):
            return project(x + t * d, eta)

        def f_at(t):
            x_new = x_at(t)
            return fun(x_new) + alpha * torch.sum(torch.abs(x_new))

        if line_search == "brent":
            # brackets made on the device: no host-to-device copies
            t, _ = golden_section(f_at, x.new_zeros(()), 10.0,
                                  maxiter=ls_maxiter)
        elif line_search == "backtrack":
            t, _ = backtracking_armijo(
                f_at, f, lambda t: torch.sum(v * (x_at(t) - x)), t_init,
                decay=ls_decay, sufficient=ls_tol, maxiter=ls_bt_maxiter)
        else:
            t = t_init

        x_new = x_at(t)
        delta = torch.linalg.vector_norm(x_new - x)
        f, g, gp = evaluate(x_new)
        if verbose > 1:
            print(f"iter {k + 1} - f: {float(f):.4f} - dx: "
                  f"{float(delta):.3e}")
        done = float(delta) <= xtol                             # host sync
        lb = lbfgs_update(lb, x_new, g)
        x = x_new
        t_init = torch.tensor(lr, dtype=x.dtype)
        k += 1
    if verbose:
        print(f"         Current function value: {float(f)}\n"
              f"         Iterations: {k}")
    if return_iters:
        return x, k
    return x
