"""GPSR-Basic: gradient projection for sparse reconstruction.

Counterpart of the JAX package's ``linear/solvers/gpsr.py`` (Figueiredo et
al. 2007): the positive/negative split turns the lasso into a
bound-constrained QP solved by projected gradient steps with Armijo
backtracking, an optional continuation over a tau ladder, and an optional
masked-CG debiasing phase.

By default the whole batch is one flattened problem (global inner
products, one shared step size and stopping test), as in the JAX package.
``per_sample=True`` solves each row on its own, which the JAX package
writes as a ``vmap`` of the same loops: here the loops run over the batch
with per-row reductions, and a row whose loop has ended keeps its state
while the others go on. Each loop reads its stopping flag to the host
once an iteration (one synchronization on a CUDA tensor).
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.ops.common import INNER_ITERATIONS


class _Reduce:
    """The reductions of one GPSR problem: over the whole batch (0-dim
    results), or per row (``[N, 1]`` results) with ``per_sample``."""

    def __init__(self, per_sample):
        self.kw = {"dim": 1, "keepdim": True} if per_sample else {}
        self.per_sample = per_sample

    def sum(self, a):
        return torch.sum(a, **self.kw)

    def dot(self, u, v):
        return torch.sum(u * v, **self.kw)

    def amax(self, a):
        return torch.amax(a, **self.kw) if self.per_sample else torch.max(a)

    def norm(self, a):
        return torch.sqrt(self.dot(a, a))


def _gpsr_core(x0, u0, v0, y, tau, A, AT, Ay, mu, lambda_backtrack,
               maxiter, miniter, tol, stop_criterion, red, ls_maxiter=50,
               verbose=False):
    """The GP loop. Returns (x, u, v, n_iter); ``n_iter`` is an int, or an
    [N] tensor of the rows' counts with per-row reductions."""
    relu = lambda a: torch.clamp_min(a, 0.0)
    keep = lambda done, old, new: torch.where(done, old, new)

    resid0 = y - A(x0)
    f = 0.5 * red.dot(resid0, resid0) + tau * (red.sum(u0) + red.sum(v0))
    x, u, v = x0, u0, v0
    nz_x = x0 != 0
    resid_base = y - resid0
    verbose = int(verbose)
    if verbose:
        print(f"Initial obj = {float(f):.6e}, nz = {int(torch.sum(nz_x))}")
    done = torch.zeros_like(f, dtype=torch.bool)
    n_iter = torch.zeros(f.shape, dtype=torch.int32, device=f.device)

    while not bool(torch.all(done)):                        # host sync
        tmp = AT(resid_base) - Ay
        gradu = tmp + tau
        gradv = -tmp + tau
        old_u, old_v = u, v

        # first-guess step from the conditional gradients
        condgradu = torch.where((old_u <= 0) & (gradu >= 0), 0.0, gradu)
        condgradv = torch.where((old_v <= 0) & (gradv >= 0), 0.0, gradv)
        auv_cond = A(condgradu - condgradv)
        lambd = ((red.dot(gradu, condgradu) + red.dot(gradv, condgradv))
                 / (red.dot(auv_cond, auv_cond) + 1e-7))

        def trial(lambd):
            du = relu(u - lambd * gradu) - u
            dv = relu(v - lambd * gradv) - v
            u_t = u + du
            v_t = v + dv
            x_t = x + (du - dv)
            rb_t = A(x_t)
            r_t = y - rb_t
            f_t = (0.5 * red.dot(r_t, r_t)
                   + tau * (red.sum(u_t) + red.sum(v_t)))
            ok = f_t <= f + mu * (red.dot(gradu, du) + red.dot(gradv, dv))
            return [u_t, v_t, x_t, rb_t, f_t], ok

        def shrink(lambd, ok):
            lambd_next = torch.where(ok, lambd, lambd * lambda_backtrack)
            if verbose > 1 and not bool(ok):
                # printed only when the step is rejected
                print(f"    line-search reducing lambda to "
                      f"{float(lambd_next):.2e}")
            return lambd_next

        # Armijo backtracking on the projected step: the first trial
        # always runs, and a problem keeps its first accepted trial
        out, ok = trial(lambd)
        lambd = shrink(lambd, ok)
        j = 1
        while j < ls_maxiter and not bool(torch.all(ok | done)):  # sync
            INNER_ITERATIONS["gpsr_backtrack"] += 1
            new, ok_t = trial(lambd)
            out = [keep(ok, a, b) for a, b in zip(out, new)]
            ok = ok | ok_t
            lambd = shrink(lambd, ok)
            j += 1
        u_new, v_new, x_new, rb_new, f_new = out

        # min-shift
        uvmin = torch.minimum(u_new, v_new)
        u_out = u_new - uvmin
        v_out = v_new - uvmin
        x_out = u_out - v_out
        dx = x_out - x
        nz_new = x_out != 0
        num_nz = red.sum(nz_new)
        n_iter_new = n_iter + 1

        if verbose:
            print(f"It = {int(n_iter_new)}, obj = {float(f_new):.5e}, "
                  f"lambda = {float(lambd):.2e}, nz = {int(num_nz)}")

        if stop_criterion == 0:
            criterion = torch.where(
                num_nz >= 1, red.sum(nz_new != nz_x).to(x.dtype), -torch.inf)
        elif stop_criterion == 1:
            criterion = torch.abs(f_new - f) / f
        elif stop_criterion == 2:
            criterion = red.norm(dx) / (red.norm(x_out) + 1e-30)
        elif stop_criterion == 3:
            numer = torch.maximum(red.amax(torch.abs(torch.minimum(
                gradu, old_u))), red.amax(torch.abs(torch.minimum(
                    gradv, old_v))))
            denom = torch.maximum(red.amax(torch.abs(old_u)),
                                  red.amax(torch.abs(old_v)))
            criterion = numer / torch.clamp_min(denom, 1e-6)
        elif stop_criterion == 4:
            criterion = f_new
        else:
            raise ValueError("Unknown stopping criterion")

        if verbose:
            name = {0: "d_nz", 1: "d_f", 2: "||d_x|| / ||x||", 3: "LCP",
                    4: "f"}[stop_criterion]
            print(f"    {name} = {float(criterion):e} (target = {tol:e})")

        done_new = (((n_iter_new > miniter) & (criterion <= tol))
                    | (n_iter_new >= maxiter))
        x = keep(done, x, x_out)
        u = keep(done, u, u_out)
        v = keep(done, v, v_out)
        f = keep(done, f, f_new)
        nz_x = keep(done, nz_x, nz_new)
        resid_base = keep(done, resid_base, rb_new)
        n_iter = keep(done, n_iter, n_iter_new)
        done = done | done_new
    if red.per_sample:
        return x, u, v, n_iter.reshape(-1)
    return x, u, v, int(n_iter)


def _debias(x, y, tau, A, AT, red, tol=1e-4, miniter=0, maxiter=500):
    """CG restricted to the nonzero support of x; a problem (the batch, or
    a row with per-row reductions) with no nonzeros or more than its
    number of observations keeps x."""
    is_zero = x == 0
    num_nz = red.sum(~is_zero)
    n_obs = y.shape[1] if red.per_sample else y.numel()
    skip = (num_nz > n_obs) | (num_nz == 0)

    resid = A(x) - y
    rvec = torch.where(is_zero, 0.0, AT(resid))
    rtr = red.dot(rvec, rvec)
    cg_tol = tol * rtr
    pvec = -rvec
    k = 0
    done = skip
    xf = x
    while not bool(torch.all(done)):                        # host sync
        INNER_ITERATIONS["gpsr_debias_cg"] += 1
        RWp = A(pvec)
        Ap = torch.where(is_zero, 0.0, AT(RWp))
        alpha_cg = rtr / (red.dot(pvec, Ap) + 1e-30)
        x_new = xf + alpha_cg * pvec
        resid_new = resid + alpha_cg * RWp
        rvec_new = rvec + alpha_cg * Ap
        rtr_new = red.dot(rvec_new, rvec_new)
        beta = rtr_new / (rtr + 1e-30)
        pvec_new = -rvec_new + beta * pvec
        k += 1
        keep_going = (k <= miniter) | ((rtr_new > cg_tol) & (k <= maxiter))
        xf = torch.where(done, xf, x_new)
        resid = torch.where(done, resid, resid_new)
        rvec = torch.where(done, rvec, rvec_new)
        pvec = torch.where(done, pvec, pvec_new)
        rtr = torch.where(done, rtr, rtr_new)
        done = done | ~keep_going
    return torch.where(skip, x, xf)


def gpsr_basic(y, A, tau, AT=None, x0=None, stop_criterion=3, tol=1e-2,
               maxiter=1000, miniter=5, init=0, continuation=False,
               debias=False, cont_steps=5, first_tau_factor=None,
               mu=0.1, lambda_backtrack=0.5, tol_debias=1e-4,
               maxiter_debias=500, miniter_debias=0, generator=None,
               per_sample=False, verbose=False, return_iters=False,
               **kwargs):
    """GPSR-Basic.

    ``A``/``AT`` are matvec closures over the batch (``sparse_encode``
    builds them for a dense dictionary), or ``A`` may be a dense matrix
    for 1-D problems. ``init``: 0 zeros, 1 a standard normal draw from
    ``generator`` (a ``torch.Generator`` on y's device; seed 0 when None;
    the JAX package's ``key``), 2 ``A^T y``; ``x0`` overrides it.

    ``stop_criterion``: 0 the change of the support, 1 the relative change
    of the objective, 2 the relative step, 3 the LCP residual (default),
    4 the objective; ``tol`` its target. With ``continuation`` the solve
    runs a ladder of ``cont_steps`` taus down to ``tau``, the earlier
    rungs on criterion 3 with tol 1e-3.

    ``per_sample=True`` (batched ``y`` only) solves each row on its own:
    its own step sizes, line searches, continuation ladder, stopping and
    debias phase. ``verbose`` prints the report lines of the batch mode.
    ``return_iters`` also returns the total GP iteration count across the
    ladder (an int, or an [N] tensor with ``per_sample``).
    """
    if stop_criterion not in (0, 1, 2, 3, 4):
        raise ValueError("Unknown stopping criterion")
    if callable(A):
        if not callable(AT):
            raise ValueError(
                "The function handle for transpose of A is missing")
    else:
        A_mat = A
        AT = lambda v: A_mat.T @ v
        A = lambda v: A_mat @ v

    Ay = AT(y)
    if x0 is not None:
        x = x0
    elif init == 0:
        x = torch.zeros_like(Ay)
    elif init == 1:
        if generator is None:
            generator = torch.Generator(device=Ay.device).manual_seed(0)
        x = torch.randn(Ay.shape, generator=generator, dtype=Ay.dtype,
                        device=Ay.device)
    elif init == 2:
        x = Ay
    else:
        raise ValueError("Unknown initialization option")

    per_sample = per_sample and y.ndim == 2
    red = _Reduce(per_sample)
    tau = torch.as_tensor(tau, dtype=Ay.dtype, device=Ay.device)
    # the trivial solution: tau >= ||A^T y||_inf
    max_tau = red.amax(torch.abs(Ay))
    trivial = tau >= max_tau

    # the continuation ladder: cont_steps factors from first_tau_factor
    # down to 1, evenly spaced in log10
    if continuation:
        if first_tau_factor is None:
            ftf = 0.8 * max_tau / tau
        else:
            ftf = torch.where(first_tau_factor * tau >= max_tau,
                              0.8 * max_tau / tau,
                              torch.as_tensor(first_tau_factor,
                                              dtype=Ay.dtype,
                                              device=Ay.device))
        start = torch.log10(ftf)
        div = cont_steps - 1
        # jnp.linspace(start, 0, cont_steps)'s arithmetic
        exps = ([start * (1 - torch.tensor(i, dtype=Ay.dtype) / div)
                 for i in range(div)] + [torch.zeros_like(start)]
                if div > 0 else [start])
        cont_factors = [10.0 ** e for e in exps]
    else:
        cont_factors = [torch.ones((), dtype=Ay.dtype, device=Ay.device)]

    u = torch.clamp_min(x, 0.0)
    v = torch.clamp_min(-x, 0.0)

    def final_summary(x_cur, label=""):
        r = y - A(x_cur)
        f = 0.5 * torch.sum(r * r) + tau * torch.sum(torch.abs(x_cur))
        print(f"{label}Final obj = {float(f):.6e}, "
              f"nz = {int(torch.sum(x_cur != 0))}")

    n_iter_total = 0
    for i, factor in enumerate(cont_factors):
        is_last = i + 1 == len(cont_factors)
        x, u, v, n_it = _gpsr_core(
            x, u, v, y, tau * factor, A, AT, Ay, mu, lambda_backtrack,
            maxiter, miniter, tol if is_last else 1e-3,
            stop_criterion if is_last else 3, red,
            verbose=verbose and not per_sample)
        n_iter_total = n_iter_total + n_it

    if verbose and not per_sample:
        final_summary(x)
    if debias:
        x = _debias(x, y, tau, A, AT, red, tol=tol_debias,
                    miniter=miniter_debias, maxiter=maxiter_debias)
        if verbose and not per_sample:
            final_summary(x, label="debiased: ")

    xf = torch.where(trivial, torch.zeros_like(x), x)
    if return_iters:
        return xf, n_iter_total
    return xf
