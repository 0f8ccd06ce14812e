"""ISTA / FISTA with optional backtracking line search: the default solver.

Counterpart of the JAX package's ``linear/solvers/ista.py``. Problem:
``min_z 0.5 ||z W^T - x||^2 + alpha ||z||_1`` with x: [N, D], weight
W: [D, K], codes z: [N, K].

Python loops take the place of ``lax.while_loop``. The loop predicate
``delta <= numel * tol`` is read to the host once per block: once per
iteration on the single-step paths, once per ``fuse_steps`` iterations on
the fused multi-step path (never once per sub-step). The momentum
recurrence is unrolled on the host in float32 (0-d CPU tensors), as the
JAX package unrolls it in float32.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.spectral import lipschitz_constant
from lasso_tpu_torch.ops.common import (check_axis_name, global_tol, matmul,
                                        pad_lasso_operands,
                                        per_feature_alpha_row,
                                        per_sample_alpha_column, psum,
                                        resolve_pallas)
from lasso_tpu_torch.ops.fused_ista import (fused_fista_multistep,
                                            fused_fista_step,
                                            supports_fused_step)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _backtracking_step(z, x, weight, alpha, lr0, eta, maxiter, prec,
                       shrink=soft_threshold, l2=0.0):
    """One FISTA step with backtracking. The gradient is evaluated once at
    ``z``; the step size shrinks until ``F(z_next) <= Q(z_next, lr)``.
    Returns ``(z_next, lr)``; on failure the base step size is used."""
    resid_0 = matmul(z, weight.T, prec) - x
    fval_0 = 0.5 * torch.sum(torch.square(resid_0))
    fgrad_0 = matmul(resid_0, weight, prec)

    def trial(lr):
        z_next = shrink(z - lr * fgrad_0, alpha * lr) / (1.0 + l2 * lr)
        resid_1 = matmul(z_next, weight.T, prec) - x
        g1 = (torch.sum(alpha * torch.abs(z_next))
              + 0.5 * l2 * torch.sum(torch.square(z_next)))
        F_next = 0.5 * torch.sum(torch.square(resid_1)) + g1
        dz = z_next - z
        Q_next = (fval_0 + torch.sum(dz * fgrad_0)
                  + (0.5 / lr) * torch.sum(torch.square(dz)) + g1)
        return z_next, bool(F_next <= Q_next)

    lr = _f32(lr0)
    accepted, k = False, 0
    while not accepted and k < maxiter:
        z_next, accepted = trial(lr)
        if not accepted:
            lr = lr / eta
        k += 1
    if not accepted:
        z_next = shrink(z - lr0 * fgrad_0, alpha * lr0) / (1.0 + l2 * lr0)
        lr = _f32(lr0)
    return z_next, lr


def _mixed_tail_blocks(n_blocks):
    """Default f32-tail length for 'mixed': ~12.5% of the blocks, at least
    1, always leaving at least 1 bf16 block; a single block runs f32."""
    if n_blocks <= 1:
        return n_blocks
    return min(n_blocks - 1, max(1, n_blocks // 8))


def _resolve_mixed_tail(mixed_tail, n_blocks):
    """Resolve the ista(mixed_tail=...) argument to a block count."""
    if mixed_tail == "auto":
        return _mixed_tail_blocks(n_blocks)
    t = int(mixed_tail)
    if t < 1:
        raise ValueError(f"mixed_tail must be >= 1 block, got {mixed_tail}")
    return min(n_blocks, t)


def _resolve_tail_iters(mixed_tail, mixed_tail_iters, maxiter, S):
    """f32-tail length for 'mixed', in iterations: ``mixed_tail_iters``
    exactly when given, else ``mixed_tail`` blocks plus the single-step
    remainder ``maxiter % S``."""
    if mixed_tail_iters is not None:
        t = int(mixed_tail_iters)
        if t < 1:
            raise ValueError(
                f"mixed_tail_iters must be >= 1, got {mixed_tail_iters}")
        return min(maxiter, t)
    tail_blocks = _resolve_mixed_tail(mixed_tail, max(1, maxiter // S))
    return min(maxiter, tail_blocks * S + maxiter % S)


def _fuse_steps(fuse_steps, fused, maxiter, verbose):
    """Iterations per fused block: 'auto' takes the largest divisor of
    ``maxiter`` <= 32, or 16 with single-step remainders when there is no
    divisor >= 8."""
    if verbose:
        S = 1
    elif fuse_steps == "auto":
        if fused:
            S = next((s for s in range(min(32, maxiter), 0, -1)
                      if maxiter % s == 0), 1)
            if S < 8:
                S = min(16, maxiter)
        else:
            S = 1
    else:
        S = max(1, int(fuse_steps)) if fused else 1
    return min(S, maxiter)


def _loss(x, z, weight, alpha, l2, prec):
    resid = matmul(z, weight.T, prec) - x
    return (0.5 * torch.sum(torch.square(resid))
            + torch.sum(alpha * torch.abs(z))
            + 0.5 * l2 * torch.sum(torch.square(z))) / x.shape[0]


def ista(x, z0, weight, alpha=1.0, fast=True, lr="auto", maxiter=10,
         tol=1e-5, backtrack=False, eta_backtrack=1.5, backtrack_maxiter=1000,
         power_iters=500, precision=None, use_pallas="auto",
         kernel_precision="f32", fuse_steps="auto", mixed_tail="auto",
         mixed_tail_iters=None, axis_name=None, per_sample_tol=False,
         restart=False, nonneg=False, l2=0.0, verbose=False,
         return_iters=False):
    """(F)ISTA for the batched lasso, on the device of ``x``.

    The arguments are those of the JAX package's ``ista``:

    * ``lr='auto'`` sets ``1/L``, ``L`` the top eigenvalue of ``W^T W``
      by power iteration (:func:`lasso_tpu_torch.linalg.lipschitz_constant`).
    * ``use_pallas`` keeps its name so that both packages take the same
      keywords. It picks the fused step functions of
      :mod:`lasso_tpu_torch.ops.fused_ista`: 'auto' for CUDA tensors of
      supported shapes, where they launch the CUDA kernels; True whenever
      the shapes are supported, so that on the CPU the plain versions of
      the kernels run (as the JAX package runs its kernels in interpret
      mode off the TPU); False never (the plain unfused step).
    * ``kernel_precision`` 'f32', 'bf16', or 'mixed' (bf16 blocks, then an
      f32 tail of ``mixed_tail`` blocks or ``mixed_tail_iters``
      iterations; needs the fused path).
    * ``fuse_steps``: iterations per fused call. Convergence is tested at
      block ends, so with ``tol > 0`` the solver may run up to
      ``fuse_steps - 1`` iterations past the every-iteration stopping
      point, and never stops earlier.
    * ``per_sample_tol`` freezes each row once its own ``sum|dz_i| <=
      K * tol`` (plain step only).
    * ``restart``: per-row adaptive momentum restart (needs ``fast``;
      exclusive with ``backtrack`` and ``per_sample_tol``).
    * ``nonneg``: the non-negative lasso. ``l2 > 0``: the elastic net.
    * ``alpha``: a scalar, an ``[N]`` per-sample vector (solved as the
      alpha=1 problem on row-rescaled inputs) or a ``[1, K]`` per-feature
      row (an elementwise threshold row).
    * ``axis_name``: a ``torch.distributed.ProcessGroup`` whose ranks
      each hold rows of one batch (:mod:`lasso_tpu_torch.parallel`). The
      threshold is then the sum of each rank's own ``numel * tol`` and
      ``sum|dz|`` is all-reduced before the host reads it, once a block,
      so that every rank stops at the same iteration. ``per_sample_tol``
      needs no reduction (rows are whole on a rank).

    Returns codes ``z`` ([N, K]); with ``return_iters=True`` also the
    number of iterations executed (an int).
    """
    check_axis_name(axis_name)
    a_row = per_feature_alpha_row(alpha, weight.shape[1], x.shape[0])
    if a_row is not None:
        alpha = a_row.to(dtype=torch.float32, device=x.device)
    a_col = (None if a_row is not None
             else per_sample_alpha_column(alpha, x.shape[0]))
    if a_col is not None:
        a_col = a_col.to(dtype=x.dtype, device=x.device)
        out = ista(x / a_col, z0 / a_col, weight, 1.0, fast=fast, lr=lr,
                   maxiter=maxiter, tol=tol, backtrack=backtrack,
                   eta_backtrack=eta_backtrack,
                   backtrack_maxiter=backtrack_maxiter,
                   power_iters=power_iters, precision=precision,
                   use_pallas=use_pallas, kernel_precision=kernel_precision,
                   fuse_steps=fuse_steps, mixed_tail=mixed_tail,
                   mixed_tail_iters=mixed_tail_iters, axis_name=axis_name,
                   per_sample_tol=per_sample_tol, restart=restart,
                   nonneg=nonneg, l2=l2, verbose=verbose,
                   return_iters=return_iters)
        if return_iters:
            z_u, k = out
            return z_u * a_col, k
        return out * a_col

    # Pad onto the fused path's grid when the shapes are not aligned but
    # a zero-padded problem is: exact (see ops.common.pad_lasso_operands),
    # with tol rescaled so that numel * tol keeps the original numel.
    if not (backtrack or per_sample_tol or verbose):
        pad = (None if supports_fused_step(x, z0, weight)
               else pad_lasso_operands(x, z0, weight, alpha))
        if (pad is not None
                and supports_fused_step(pad[0], pad[1], pad[2])
                and resolve_pallas(use_pallas, True, x.device)):
            x_p, z0_p, w_p, a_p, (N0, K0) = pad
            out = ista(x_p, z0_p, w_p, alpha if a_p is None else a_p,
                       fast=fast, lr=lr, maxiter=maxiter,
                       tol=tol * (N0 * K0) / z0_p.numel(),
                       power_iters=power_iters, precision=precision,
                       use_pallas=use_pallas,
                       kernel_precision=kernel_precision,
                       fuse_steps=fuse_steps, mixed_tail=mixed_tail,
                       mixed_tail_iters=mixed_tail_iters,
                       axis_name=axis_name, restart=restart,
                       nonneg=nonneg, l2=l2, return_iters=return_iters)
            if return_iters:
                z_u, k = out
                return z_u[:N0, :K0], k
            return out[:N0, :K0]

    if kernel_precision not in ("f32", "bf16", "mixed"):
        raise ValueError(f"kernel_precision must be 'f32', 'bf16' or "
                         f"'mixed', got {kernel_precision!r}")
    if mixed_tail_iters is not None and kernel_precision != "mixed":
        raise ValueError("mixed_tail_iters requires "
                         "kernel_precision='mixed'")
    if restart and (not fast or backtrack or per_sample_tol):
        raise ValueError("restart=True requires fast=True and is "
                         "exclusive with backtrack/per_sample_tol")

    prec = get_precision(precision)
    shrink = soft_threshold_nonneg if nonneg else soft_threshold
    if isinstance(lr, str):
        if lr != "auto":
            raise ValueError(f"invalid lr {lr!r}")
        L = lipschitz_constant(weight, maxiter=power_iters, precision=prec)
        lr = 1.0 / L
    # every scalar of the recurrence is a float32 0-d tensor on the host
    lr = _f32(lr).cpu()
    prox_scale = 1.0 / (1.0 + l2 * lr)
    # delta (float32) is compared with numel * tol rounded to float32
    tol_total = global_tol(z0.numel(), tol, torch.float32, axis_name,
                           x.device)
    tol_row = weight.shape[1] * tol  # per-sample numel * tol

    fused = resolve_pallas(
        use_pallas, not backtrack and not per_sample_tol
        and supports_fused_step(x, z0, weight), x.device)
    if fused:
        x, z0, weight = x.contiguous(), z0.contiguous(), weight.contiguous()
    S = _fuse_steps(fuse_steps, fused, maxiter, verbose)

    def rss_grad(z_k):
        resid = matmul(z_k, weight.T, prec) - x
        return matmul(resid, weight, prec)

    if restart:
        z, k = _ista_restart(x, z0, weight, alpha, lr, maxiter, tol_total,
                             prox_scale, shrink, rss_grad, fused, S,
                             kernel_precision, mixed_tail, mixed_tail_iters,
                             nonneg, l2, verbose, prec, axis_name)
        return (z, k) if return_iters else z

    one, zero = _f32(1.0), _f32(0.0)
    z, z_prev, t, mom, k = z0, z0, one, zero, 0
    done = (torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
            if per_sample_tol else False)

    def run_blocks(kp, limit, steps):
        nonlocal z, z_prev, t, mom, k, done
        while not done and k + steps <= limit:
            # unroll the (data-independent) t/momentum recurrence for the
            # sub-steps of this block
            mom_list = []
            t_c, m_c = t, mom
            for _ in range(steps):
                mom_list.append(m_c)
                if fast:
                    t_n = (1 + torch.sqrt(1 + 4 * t_c * t_c)) / 2
                    m_c = (t_c - 1) / t_n
                    t_c = t_n
            z, z_prev, delta = fused_fista_multistep(
                x, z, z_prev, weight, lr, alpha * lr, torch.stack(mom_list),
                steps=steps, kernel_precision=kp, nonneg=nonneg, l2=l2)
            done = float(psum(delta, axis_name)) <= tol_total
            t, mom, k = t_c, m_c, k + steps

    if S > 1:
        if kernel_precision == "mixed":
            # bf16 S-blocks, a bf16 remainder block, then the f32 tail in
            # S_t-blocks and an f32 remainder block
            tail_iters = _resolve_tail_iters(mixed_tail, mixed_tail_iters,
                                             maxiter, S)
            n_bf16 = maxiter - tail_iters
            run_blocks("bf16", n_bf16, S)
            r1 = n_bf16 % S
            if r1:
                run_blocks("bf16", n_bf16, r1)
            # the bf16 phase's verdict is bf16-grade: the f32 tail always
            # runs
            done = False
            S_t = min(S, tail_iters)
            r2 = tail_iters % S_t
            run_blocks("f32", maxiter - r2, S_t)
            if r2:
                run_blocks("f32", maxiter, r2)
        else:
            run_blocks(kernel_precision, maxiter, S)

    def not_done():
        if per_sample_tol:
            return not bool(torch.all(done))
        return not done

    while not_done() and k < maxiter:
        # mom is the momentum coefficient of THIS step's y, lagging the
        # t-update by one iteration: y_k = z_k + ((t_{k-1} - 1)/t_k)(...)
        if verbose:
            print(f"loss: {float(_loss(x, z, weight, alpha, l2, prec)):.4f}")
        if fused:
            # under 'mixed' a single-step remainder belongs to the f32 tail
            z_next, delta = fused_fista_step(
                x, z, z_prev, weight, lr, alpha, mom,
                kernel_precision=("f32" if kernel_precision == "mixed"
                                  else kernel_precision),
                nonneg=nonneg, l2=l2)
        else:
            y = z + mom * (z - z_prev)
            if backtrack:
                z_next, _ = _backtracking_step(
                    y, x, weight, alpha, lr, eta_backtrack,
                    backtrack_maxiter, prec, shrink=shrink, l2=l2)
            else:
                z_next = shrink(y - lr * rss_grad(y), alpha * lr) \
                    * prox_scale
            if per_sample_tol:
                delta_row = torch.sum(torch.abs(z - z_next), dim=1)
            else:
                delta = torch.sum(torch.abs(z - z_next))
        if per_sample_tol:
            # permanent per-row freeze
            keep = done[:, None]
            done = torch.logical_or(done, delta_row <= tol_row)
            z_next = torch.where(keep, z, z_next)
            z = torch.where(keep, z_prev, z)
        else:
            done = float(psum(delta, axis_name)) <= tol_total
        if fast:
            t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
            mom = (t - 1) / t_next
            t = t_next
        z, z_prev, k = z_next, z, k + 1

    return (z, k) if return_iters else z


def _ista_restart(x, z0, weight, alpha, lr, maxiter, tol_total, prox_scale,
                  shrink, rss_grad, fused, S, kernel_precision, mixed_tail,
                  mixed_tail_iters, nonneg, l2, verbose, prec,
                  axis_name=None):
    """FISTA with per-row adaptive restart. Returns ``(z, n_iter)``."""
    # carry convention t_{k-1}, init 0: the first momentum coefficient is
    # (0 - 1)/1 = -1 against a zero (z - z_prev) difference
    t_vec = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                        device=x.device)
    z, z_prev, k, done = z0, z0, 0, False

    if fused and S > 1:
        # per-feature [1, K] alpha: the kernels take the threshold row
        # (alpha * lr); otherwise a per-sub-step scalar
        a_f32 = (alpha if torch.is_tensor(alpha) and alpha.ndim == 2
                 else _f32(alpha))

        def run_blocks(kp, limit, steps):
            nonlocal z, z_prev, t_vec, k, done
            th_s = a_f32 * lr if a_f32.ndim == 2 else lr * a_f32
            while not done and k + steps <= limit:
                z, z_prev, t_vec, delta = fused_fista_multistep(
                    x, z, z_prev, weight, lr, th_s, 0.0, steps=steps,
                    kernel_precision=kp, t_vec=t_vec, nonneg=nonneg, l2=l2)
                done = float(psum(delta, axis_name)) <= tol_total
                k += steps

        if kernel_precision == "mixed":
            # the per-row t-vector carries across the phase switch
            tail_iters = _resolve_tail_iters(mixed_tail, mixed_tail_iters,
                                             maxiter, S)
            n_bf16 = maxiter - tail_iters
            run_blocks("bf16", n_bf16, S)
            r1 = n_bf16 % S
            if r1:
                run_blocks("bf16", n_bf16, r1)
            done = False
            S_t = min(S, tail_iters)
            r2 = tail_iters % S_t
            run_blocks("f32", maxiter - r2, S_t)
            if r2:
                run_blocks("f32", maxiter, r2)
        else:
            run_blocks(kernel_precision, maxiter, S)

    while not done and k < maxiter:
        if verbose:
            print(f"loss: {float(_loss(x, z, weight, alpha, l2, prec)):.4f}")
        t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t_vec * t_vec)) * 0.5
        y = z + ((t_vec - 1.0) / t_next) * (z - z_prev)
        z_new = shrink(y - lr * rss_grad(y), alpha * lr) * prox_scale
        rdot = torch.sum((y - z_new) * (z_new - z), dim=1, keepdim=True)
        t_vec = torch.where(rdot > 0, 1.0, t_next)
        delta = torch.sum(torch.abs(z_new - z))
        z, z_prev, k = z_new, z, k + 1
        done = float(psum(delta, axis_name)) <= tol_total
    return z, k
