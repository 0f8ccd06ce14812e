"""Batched coordinate descent, two variants.

Counterpart of the JAX package's ``linear/solvers/coordinate_descent.py``.

``coord_descent``: Li & Osher's greedy CD. Per sample, update the
coordinate with the largest candidate change each iteration; a sample
whose change falls to ``tol * K`` or below is frozen (an active mask).

``coord_descent_mod``: the cyclic, sklearn-compatible variant with a
per-sample duality-gap stopping test.

Python loops take the place of ``lax.while_loop``. The loop predicate is
read to the host once per block: once per fused block of ``fuse_steps``
greedy steps (never once per sub-step), once per unfused greedy step,
and once per cyclic sweep.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.ops.common import (matmul, pad_lasso_operands,
                                        per_feature_alpha_row,
                                        per_sample_alpha_column,
                                        resolve_pallas)
from lasso_tpu_torch.ops.fused_cd import (fused_cd_mod_sweep, fused_cd_steps,
                                          supports_fused_cd,
                                          supports_fused_cd_mod)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg


def _f32(v, device=None):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def coord_descent(x, W, z0=None, alpha=1.0, maxiter=1000, tol=1e-6,
                  precision=None, use_pallas="auto", kernel_precision="f32",
                  fuse_steps=8, nonneg=False, l2=0.0, verbose=False,
                  return_iters=False):
    """Greedy batched CD. x: [N, D], W: [D, K] -> z: [N, K].

    The arguments are those of the JAX package's ``coord_descent``:

    * ``use_pallas`` picks the fused steps of
      :mod:`lasso_tpu_torch.ops.fused_cd`: 'auto' for CUDA tensors of
      supported shapes (the K3 kernel), True whenever the shapes are
      supported (on the CPU the kernel's plain version runs, as the JAX
      package runs its kernel in interpret mode off the TPU), False never.
      Fused blocks of ``fuse_steps`` steps run while any row is active and
      a whole block fits the budget; single unfused steps (PyTorch ops,
      also on the card) finish it.
    * ``kernel_precision`` 'f32', 'bf16' (S rows rounded to bf16) or
      'mixed': bf16 blocks for about 3/4 of the budget, then ``b`` is
      rebuilt in f32 from the invariant ``b = x W + z (I - W^T W)``, every
      row is reactivated, and f32 blocks and the unfused tail follow.
      The unfused path always runs f32.
    * ``alpha``: a scalar, an ``[N]`` per-sample vector (solved as the
      alpha=1 problem on row-rescaled inputs) or a ``[1, K]`` per-feature
      threshold row.
    * ``nonneg``: the non-negative lasso; ``l2 > 0``: the elastic net
      (the coordinate minimizer of unit-norm atoms is
      ``shrink(b_k, alpha) / (1 + l2)``).
    * ``verbose`` prints the objective of ``prox(b)`` every iteration and
      forces the unfused path.
    * A warm start ``z0`` keeps the invariant ``b = x W + z0 S``.

    Returns ``z``, or ``(z, n_iter)`` (an int) with ``return_iters``.
    """
    a_row = per_feature_alpha_row(alpha, W.shape[1], x.shape[0])
    if a_row is not None:
        alpha = a_row.to(dtype=torch.float32, device=x.device)
    a_col = (None if a_row is not None
             else per_sample_alpha_column(alpha, x.shape[0]))
    if a_col is not None:
        a_col = a_col.to(dtype=x.dtype, device=x.device)
        out = coord_descent(
            x / a_col, W, None if z0 is None else z0 / a_col, 1.0,
            maxiter=maxiter, tol=tol, precision=precision,
            use_pallas=use_pallas, kernel_precision=kernel_precision,
            fuse_steps=fuse_steps, nonneg=nonneg, l2=l2, verbose=verbose,
            return_iters=return_iters)
        if return_iters:
            z_u, it = out
            return z_u * a_col, it
        return out * a_col

    # Pad onto the fused grid (K % 128, N % 8) when the problem is not
    # aligned but the padded one is: exact (zero atoms give b_k = 0 and are
    # never selected, zero rows freeze with dz = 0), with the per-row
    # threshold tol * K kept at the original K.
    if not verbose:
        b_shape = torch.empty((x.shape[0], W.shape[1]), dtype=x.dtype,
                              device="meta")
        pad = (None if supports_fused_cd(b_shape, W)
               else pad_lasso_operands(x, z0, W, alpha))
        if pad is not None:
            x_p, z0_p, w_p, a_p, (N0, K0) = pad
            b_p = torch.empty((x_p.shape[0], w_p.shape[1]), dtype=x.dtype,
                              device="meta")
            if (supports_fused_cd(b_p, w_p)
                    and resolve_pallas(use_pallas, True, x.device)):
                out = coord_descent(
                    x_p, w_p, z0_p, alpha if a_p is None else a_p,
                    maxiter=maxiter, tol=tol * K0 / w_p.shape[1],
                    precision=precision, use_pallas=use_pallas,
                    kernel_precision=kernel_precision,
                    fuse_steps=fuse_steps, nonneg=nonneg, l2=l2,
                    return_iters=return_iters)
                if return_iters:
                    z_u, it = out
                    return z_u[:N0, :K0], it
                return out[:N0, :K0]

    if kernel_precision not in ("f32", "bf16", "mixed"):
        raise ValueError(f"kernel_precision must be 'f32', 'bf16' or "
                         f"'mixed', got {kernel_precision!r}")
    prec = get_precision(precision)
    N = x.shape[0]
    K = W.shape[1]
    if x.shape[1] != W.shape[0]:
        raise ValueError(f"x has {x.shape[1]} features, W has {W.shape[0]}")
    dev = x.device
    tol_k = _f32(tol * K, dev)

    # S = I - W^T W (symmetric)
    S = torch.eye(K, dtype=W.dtype, device=dev) - matmul(W.T, W, prec)
    b0 = matmul(x, W, prec)
    if z0 is None:
        z0 = torch.zeros((N, K), dtype=x.dtype, device=dev)
    else:
        if tuple(z0.shape) != (N, K):
            raise ValueError(f"z0 has shape {tuple(z0.shape)}, expected "
                             f"{(N, K)}")
        b0 = b0 + matmul(z0, S, prec)

    prox = soft_threshold_nonneg if nonneg else soft_threshold
    cd_scale = 1.0 / (1.0 + _f32(l2, dev))
    fused = resolve_pallas(use_pallas,
                           not verbose and supports_fused_cd(b0, W), dev)
    T = max(1, int(fuse_steps)) if fused else 1

    z, b, it = z0, b0, 0
    active = torch.ones((N, 1), dtype=torch.float32, device=dev)
    if fused and T > 1:
        z = z.contiguous()

        def run_blocks(kp, limit):
            nonlocal z, b, active, it
            while it + T <= limit and bool(torch.any(active > 0)):
                b, z, active = fused_cd_steps(
                    b, z, active, S, alpha, tol_k, steps=T,
                    kernel_precision=kp, nonneg=nonneg, l2=l2)
                it += T

        if kernel_precision == "mixed":
            run_blocks("bf16", (max(1, (3 * maxiter) // 4) // T) * T)
            # phase switch: rebuild b from the invariant in f32 and
            # reactivate every row; the bf16 phase's active-set decisions
            # and accumulated rounding of b are both discarded
            b = matmul(x, W, prec) + matmul(z, S, prec)
            active = torch.ones_like(active)
            run_blocks("f32", maxiter)
        else:
            run_blocks(kernel_precision, maxiter)

    active = active[:, 0] > 0
    rows = torch.arange(N, device=dev)
    while it < maxiter and bool(torch.any(active)):
        z_cand = prox(b, alpha) * cd_scale
        if verbose:
            resid = matmul(z_cand, W.T, prec) - x
            loss = (0.5 * torch.sum(torch.square(resid))
                    + torch.sum(alpha * torch.abs(z_cand))
                    + 0.5 * l2 * torch.sum(torch.square(z_cand)))
            print(f"iter {it} - loss: {float(loss):.4f}")
        diff = z_cand - z
        k = torch.argmax(torch.abs(diff), dim=1)                   # [N]
        dz = torch.gather(diff, 1, k[:, None])                      # [N, 1]
        # S is symmetric, so S[:, k].T == S[k, :]
        b_new = torch.addcmul(b, S[k, :], dz)
        z_new = z.clone()
        z_new[rows, k] = torch.gather(z_cand, 1, k[:, None])[:, 0]
        mask = active[:, None]
        active = torch.logical_and(active, torch.abs(dz)[:, 0] > tol_k)
        b = torch.where(mask, b_new, b)
        z = torch.where(mask, z_new, z)
        it += 1

    zf = prox(b, alpha) * cd_scale
    return (zf, it) if return_iters else zf


def _sweep_unfused(z, R, converged, W, norm_cols, alpha, l2, prec):
    """One cyclic sweep in the unfused form of the JAX package's
    ``sweep_component`` (the add-back residual R1 is formed)."""
    N, K = z.shape
    z = z.clone()
    z_max = torch.zeros((N,), dtype=z.dtype, device=z.device)
    d_z_max = torch.zeros_like(z_max)
    for i in range(K):
        atom = W[:, i]
        col_ok = norm_cols[i] != 0
        active = torch.logical_and(~converged, col_ok)
        z_i = z[:, i].clone()
        add_mask = torch.logical_and(active, z_i != 0)
        R1 = R + torch.where(add_mask, z_i, 0.0)[:, None] * atom[None, :]
        rho = matmul(R1, atom, prec)
        z_i_new = soft_threshold(rho, alpha) \
            / (torch.where(col_ok, norm_cols[i], 1.0) + l2)
        z_i_new = torch.where(active, z_i_new, z_i)
        sub_mask = torch.logical_and(active, z_i_new != 0)
        R = R1 - torch.where(sub_mask, z_i_new, 0.0)[:, None] * atom[None, :]
        z[:, i] = z_i_new
        d_z_max = torch.where(
            active, torch.maximum(d_z_max, torch.abs(z_i_new - z_i)), d_z_max)
        z_max = torch.where(active, torch.maximum(z_max, torch.abs(z_i_new)),
                            z_max)
    return z, R, z_max, d_z_max


def coord_descent_mod(x, W, z0=None, alpha=1.0, max_iter=1000, tol=1e-4,
                      l2=0.0, precision=None, use_pallas="auto",
                      return_iters=False):
    """Cyclic CD with a per-sample duality-gap stop.

    Returns ``(z, gap)`` with ``gap`` the per-sample duality gap at the
    last convergence check, plus the number of sweeps (an int) with
    ``return_iters``. Each sweep runs as one launch of the K4 kernel
    (:func:`lasso_tpu_torch.ops.fused_cd.fused_cd_mod_sweep`) on a CUDA
    tensor with ``use_pallas`` 'auto' or True, as its plain version on a
    CPU tensor with True, and as the unfused PyTorch sweep otherwise. The
    gap is computed between sweeps and taken only for rows whose sweep
    stalled (``dzmax / zmax < tol``, or no change) or on the last sweep.

    ``l2 > 0`` solves the elastic net: the coordinate denominator becomes
    ``||w_j||^2 + l2`` and the gap takes the elastic-net form.
    """
    prec = get_precision(precision)
    n_features, n_components = W.shape
    n_samples = x.shape[0]
    if x.shape[1] != n_features:
        raise ValueError(f"x has {x.shape[1]} features, W has {n_features}")
    if z0 is None:
        z0 = torch.zeros((n_samples, n_components), dtype=x.dtype,
                         device=x.device)
    elif tuple(z0.shape) != (n_samples, n_components):
        raise ValueError(f"z0 has shape {tuple(z0.shape)}, expected "
                         f"{(n_samples, n_components)}")

    d_w_tol = tol
    tol_per_sample = tol * torch.sum(torch.square(x), dim=1)      # [N]
    norm_cols = torch.sum(torch.square(W), dim=0)                 # [K]

    def check_convergence(z, R):
        """Per-sample duality gap; with ``l2 > 0`` the elastic-net form."""
        XtA = matmul(R, W, prec) - l2 * z                        # [N, K]
        dual_norm = torch.amax(torch.abs(XtA), dim=1)            # [N]
        R_norm2 = torch.sum(torch.square(R), dim=1)              # [N]
        small = dual_norm <= alpha
        const = torch.where(small, 1.0,
                            alpha / torch.where(small, 1.0, dual_norm))
        gap = torch.where(small, R_norm2, 0.5 * R_norm2 * (1 + const ** 2))
        gap = gap + alpha * torch.sum(torch.abs(z), dim=1) \
            - const * torch.sum(R * x, dim=1) \
            + 0.5 * l2 * (1 + const ** 2) * torch.sum(torch.square(z), dim=1)
        return gap < tol_per_sample, gap

    R = x - matmul(z0, W.T, prec)
    fused = resolve_pallas(use_pallas, supports_fused_cd_mod(z0, W),
                           x.device)
    z = z0.contiguous()
    gap = torch.full((n_samples,), tol + 1.0, dtype=x.dtype, device=x.device)
    converged = torch.zeros((n_samples,), dtype=torch.bool, device=x.device)
    n_iter = 0
    while n_iter < max_iter and not bool(torch.all(converged)):
        if fused:
            z, R, z_max, d_z_max = fused_cd_mod_sweep(
                z, R, converged, W, norm_cols, alpha, l2=l2)
        else:
            z, R, z_max, d_z_max = _sweep_unfused(
                z, R, converged, W, norm_cols, alpha, l2, prec)
        # the gap is taken only for rows whose sweep stalled, or on the
        # last sweep
        check = (z_max == 0) | (d_z_max / torch.where(z_max == 0, 1.0, z_max)
                                < d_w_tol)
        if n_iter == max_iter - 1:
            check = torch.ones_like(check)
        check = torch.logical_and(check, ~converged)
        conv_new, gap_new = check_convergence(z, R)
        converged = torch.where(check, conv_new, converged)
        gap = torch.where(check, gap_new, gap)
        n_iter += 1
    if return_iters:
        return z, gap, n_iter
    return z, gap
