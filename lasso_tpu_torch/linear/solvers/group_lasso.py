"""Group lasso and sparse-group lasso (proximal gradient / FISTA).

Counterpart of the JAX package's ``linear/solvers/group_lasso.py``:

    min_z 0.5 ||z W^T - x||^2 + alpha * sum_g w_g ||z_g||_2
                              + l1_alpha * ||z||_1

(Yuan & Lin 2006; with ``l1_alpha > 0`` the sparse-group lasso of Simon,
Friedman, Hastie & Tibshirani 2013, whose prox is the exact composition
``group_shrink(soft_threshold(.))``).

Groups given as an int ``gs`` (contiguous equal-size blocks) make the
prox a ``[N, G, gs]`` reshape and a sum; an id array sums through
``index_add_``. Python loops take the place of ``lax.while_loop``, with
the global stopping test ``sum|dz| <= numel * tol`` read to the host once
per block (per iteration on the unfused path), as in
:mod:`lasso_tpu_torch.linear.solvers.ista`.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.spectral import lipschitz_constant
from lasso_tpu_torch.linear.solvers.ista import (_fuse_steps,
                                                 _resolve_tail_iters)
from lasso_tpu_torch.ops.common import (check_axis_name, global_tol, matmul,
                                        pad_lasso_operands,
                                        per_sample_alpha_column, psum,
                                        resolve_pallas)
from lasso_tpu_torch.ops.fused_group import (build_group_tables,
                                             fused_group_fista_multistep,
                                             group_prox_plain,
                                             supports_fused_group_step)
from lasso_tpu_torch.ops.shrink import soft_threshold


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def resolve_groups(groups, n_components):
    """Normalize the ``groups`` argument to ``(kind, data, n_groups)``.

    ``groups`` may be:
      * an int ``gs``: contiguous equal-size blocks ``[0:gs), [gs:2gs),
        ...`` (requires ``gs | K``); returns ``('block', gs, K // gs)``;
      * an integer array (numpy or tensor) of shape [K] assigning each
        coordinate a group id in ``[0, G)`` (any order, any sizes);
        returns ``('ids', ids, G)`` with ``ids`` int32 numpy.
    """
    if groups is None:
        raise ValueError("group_ista requires groups (an int block size "
                         "or a [K] int array of group ids)")
    if isinstance(groups, (int, np.integer)):
        gs = int(groups)
        if gs < 1:
            raise ValueError(f"group size must be >= 1, got {gs}")
        if n_components % gs != 0:
            raise ValueError(
                f"group size {gs} does not divide n_components "
                f"{n_components}; pass an explicit id array for ragged "
                f"groups")
        return "block", gs, n_components // gs
    ids = np.asarray(groups.cpu() if torch.is_tensor(groups) else groups)
    if ids.shape != (n_components,) or ids.dtype.kind not in "iu":
        raise ValueError(
            f"groups must be an int or an int array of shape "
            f"({n_components},), got shape {ids.shape} dtype {ids.dtype}")
    uniq = np.unique(ids)
    n_groups = int(uniq[-1]) + 1
    if int(uniq[0]) < 0 or len(uniq) != n_groups:
        raise ValueError("group ids must be 0..G-1 with every id used")
    return "ids", ids.astype(np.int32), n_groups


def _group_ids(kind, data, n_groups):
    """The ``[K]`` group id of every coordinate."""
    if kind == "block":
        return np.repeat(np.arange(n_groups, dtype=np.int32), data)
    return data


def _tables(kind, data, n_groups, device):
    return build_group_tables(_group_ids(kind, data, n_groups), n_groups,
                              device, block=data if kind == "block" else None)


def _group_weight_row(weights, n_groups, device):
    """``group_weights`` as a float32 ``[G]`` row on ``device`` (None stays
    None)."""
    if weights is None:
        return None
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    if tuple(w.shape) != (n_groups,):
        raise ValueError(f"group_weights must have shape ({n_groups},), got "
                         f"{tuple(w.shape)}")
    return w


def _make_group_prox(tables, w):
    """Build ``prox(v, theta) -> argmin_u 0.5||u-v||^2 + theta * sum_g w_g
    ||u_g||_2`` for [N, K] inputs (``w``: the ``[G]`` weights, or None):
    the blockwise shrink ``u_g = v_g * max(1 - theta*w_g/||v_g||, 0)``,
    with the 0/0 at ``||v_g|| = 0`` resolved to scale 0 (the group is
    already at the prox's fixed point)."""

    def prox(v, theta):
        th = theta if w is None else theta * w
        return group_prox_plain(v, th, tables)

    return prox


def _l1_engaged(l1_alpha):
    """Whether the l1 term participates (an all-zero l1_alpha skips the
    extra shrink entirely)."""
    return bool(torch.any(torch.as_tensor(l1_alpha) != 0.0))


def group_soft_threshold(v, theta, groups, weights=None):
    """prox of ``theta * sum_g w_g ||.||_2`` over groups of the last axis
    of a [N, K] tensor (blockwise soft threshold / group shrink)."""
    kind, data, n_groups = resolve_groups(groups, v.shape[-1])
    prox = _make_group_prox(_tables(kind, data, n_groups, v.device),
                            _group_weight_row(weights, n_groups, v.device))
    return prox(v, theta)


def group_lasso_objective(x, weight, z, alpha, groups, weights=None,
                          l1_alpha=0.0, precision=None):
    """``0.5||zW^T - x||^2 + alpha sum_g w_g ||z_g|| + l1_alpha ||z||_1``
    (total over the batch, not per-sample-mean)."""
    prec = get_precision(precision)
    kind, data, n_groups = resolve_groups(groups, weight.shape[1])
    resid = matmul(z, weight.T, prec) - x

    def _safe_sqrt(sq):
        # double-where: keep the objective reverse-differentiable at
        # exactly-zeroed groups (sqrt'(0) = inf otherwise)
        nz = sq > 0.0
        return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)

    if kind == "block":
        zb = z.reshape(z.shape[0], n_groups, data)
        norms = _safe_sqrt(torch.sum(torch.square(zb), dim=-1))
    else:
        ids = torch.from_numpy(data.astype(np.int64)).to(z.device)
        norms = _safe_sqrt(z.new_zeros((z.shape[0], n_groups)).index_add_(
            1, ids, torch.square(z)))
    w = (torch.ones((n_groups,), dtype=z.dtype, device=z.device)
         if weights is None
         else torch.as_tensor(weights, dtype=z.dtype).to(z.device))
    # sum(l1_alpha * |z|) also covers the internal per-sample [N, 1] form
    pen = alpha * torch.sum(norms * w) + torch.sum(l1_alpha * torch.abs(z))
    return 0.5 * torch.sum(torch.square(resid)) + pen


def group_ista(x, z0, weight, alpha=1.0, groups=None, group_weights=None,
               l1_alpha=0.0, fast=True, lr="auto", maxiter=100, tol=1e-5,
               power_iters=500, precision=None, axis_name=None,
               restart=False, use_pallas="auto", fuse_steps="auto",
               kernel_precision="f32", mixed_tail="auto",
               mixed_tail_iters=None, verbose=False, return_iters=False):
    """(F)ISTA for the batched group lasso / sparse-group lasso, on the
    device of ``x``.

    Problem: ``min_z 0.5||z W^T - x||^2 + alpha sum_g w_g ||z_g||_2
    + l1_alpha ||z||_1`` with x [N, D], W [D, K], z [N, K] and ``groups``
    partitioning the K coordinates (int block size or [K] id array, see
    :func:`resolve_groups`). ``group_weights`` defaults to uniform; pass
    ``sqrt(group size)`` for the Yuan-Lin weighting of ragged groups.

    The arguments are those of the JAX package's ``group_ista``, and the
    iteration, convergence test (global ``sum|dz| <= numel * tol``),
    ``restart``, ``verbose`` and ``return_iters`` match
    :func:`lasso_tpu_torch.linear.solvers.ista`. ``alpha`` is a scalar or
    an [N] per-sample vector (solved as the alpha=1 problem on row-rescaled
    inputs, ``l1_alpha`` scaled by the same factor); per-feature [1, K]
    alphas are refused, use ``group_weights``.

    ``use_pallas`` picks the fused steps of
    :mod:`lasso_tpu_torch.ops.fused_group`: 'auto' for CUDA tensors of
    supported shapes (the kernels of ``csrc/fista.cu`` and
    ``csrc/group.cu``); True whenever the shapes are supported, so that on
    the CPU the plain versions run (as the JAX package runs its kernel in
    interpret mode); False never. ``fuse_steps`` iterations run per fused
    call and convergence is tested at block ends, so the fused path never
    stops before the unfused one would; ``kernel_precision`` 'f32', 'bf16'
    or 'mixed' (bf16 blocks, then an f32 tail of ``mixed_tail`` blocks or
    ``mixed_tail_iters`` iterations). ``axis_name`` (a
    ``torch.distributed.ProcessGroup``) all-reduces the stopping sum and
    threshold over the ranks that share the batch, as in
    :func:`lasso_tpu_torch.linear.solvers.ista`.

    Returns codes ``z`` [N, K]; with ``return_iters=True`` also the number
    of iterations executed (an int).
    """
    check_axis_name(axis_name)
    n_components = weight.shape[1]
    if torch.as_tensor(alpha).ndim == 2:
        raise ValueError("group_ista takes scalar or per-sample [N] "
                         "alpha; use group_weights for per-group "
                         "penalties")
    a_col = per_sample_alpha_column(alpha, x.shape[0])
    if a_col is not None:
        # row rescale to the alpha=1 problem (1-homogeneous penalty); the
        # l1 term picks up a per-sample [N, 1] threshold, which the
        # elementwise soft_threshold broadcasts natively
        a_col = a_col.to(dtype=x.dtype, device=x.device)
        if torch.as_tensor(l1_alpha).ndim != 0:
            raise ValueError("l1_alpha must be a scalar")
        l1_scaled = l1_alpha / a_col if _l1_engaged(l1_alpha) else 0.0
        out = group_ista(
            x / a_col, z0 / a_col, weight, 1.0, groups=groups,
            group_weights=group_weights, l1_alpha=l1_scaled,
            fast=fast, lr=lr, maxiter=maxiter, tol=tol,
            power_iters=power_iters, precision=precision,
            axis_name=axis_name, restart=restart, use_pallas=use_pallas,
            fuse_steps=fuse_steps, kernel_precision=kernel_precision,
            mixed_tail=mixed_tail, mixed_tail_iters=mixed_tail_iters,
            verbose=verbose, return_iters=return_iters)
        if return_iters:
            z_u, k = out
            return z_u * a_col, k
        return out * a_col

    # Pad onto the fused path's grid when only alignment blocks it (exact:
    # zero feature and batch rows as in ops.common.pad_lasso_operands; the
    # padded zero atoms join group 0, where they add exactly 0 to its norm
    # and stay 0 under the multiplicative prox). tol is rescaled so that
    # numel * tol keeps the original numel. verbose is excluded (the
    # printed loss divides by the padded batch size).
    if not verbose and groups is not None:
        kind0, data0, ng0 = resolve_groups(groups, n_components)
        pad = (None if supports_fused_group_step(x, z0, weight, ng0)
               else pad_lasso_operands(x, z0, weight))
        if (pad is not None
                and supports_fused_group_step(pad[0], pad[1], pad[2], ng0)
                and resolve_pallas(use_pallas, True, x.device)):
            x_p, z0_p, w_p, _, (N0, K0) = pad
            ids_p = np.zeros((w_p.shape[1],), np.int32)
            ids_p[:K0] = _group_ids(kind0, data0, ng0)
            l1_p = l1_alpha
            if torch.as_tensor(l1_alpha).ndim == 2:
                l1_p = torch.nn.functional.pad(
                    torch.as_tensor(l1_alpha),
                    (0, 0, 0, x_p.shape[0] - N0), value=1.0)
            out = group_ista(
                x_p, z0_p, w_p, alpha, groups=ids_p,
                group_weights=group_weights, l1_alpha=l1_p, fast=fast,
                lr=lr, maxiter=maxiter,
                tol=tol * (N0 * K0) / z0_p.numel(),
                power_iters=power_iters, precision=precision,
                axis_name=axis_name, restart=restart,
                use_pallas=use_pallas, fuse_steps=fuse_steps,
                kernel_precision=kernel_precision, mixed_tail=mixed_tail,
                mixed_tail_iters=mixed_tail_iters,
                return_iters=return_iters)
            if return_iters:
                z_u, k = out
                return z_u[:N0, :K0], k
            return out[:N0, :K0]

    kind, data, n_groups = resolve_groups(groups, n_components)
    tables = _tables(kind, data, n_groups, x.device)
    w_row = _group_weight_row(group_weights, n_groups, x.device)
    gprox = _make_group_prox(tables, w_row)
    # a scalar stays a 0-d host tensor; the per-sample column is on x's
    # device already
    l1_arr = torch.as_tensor(l1_alpha, dtype=x.dtype)
    if l1_arr.ndim not in (0, 2):
        raise ValueError("l1_alpha must be a scalar (internal per-sample "
                         "column allowed)")
    use_l1 = _l1_engaged(l1_alpha)

    def prox(v, lr_val):
        if use_l1:
            v = soft_threshold(v, l1_arr * lr_val)
        return gprox(v, alpha * lr_val)

    prec = get_precision(precision)
    if isinstance(lr, str):
        if lr != "auto":
            raise ValueError(f"invalid lr {lr!r}")
        L = lipschitz_constant(weight, maxiter=power_iters, precision=prec)
        lr = 1.0 / L
    # every scalar of the recurrence is a float32 0-d tensor on the host
    lr = _f32(lr).cpu()
    # delta (float32) is compared with numel * tol rounded to float32
    tol_total = global_tol(z0.numel(), tol, torch.float32, axis_name,
                           x.device)

    # ---- fused-kernel routing (ops/fused_group) -------------------------
    if kernel_precision not in ("f32", "bf16", "mixed"):
        raise ValueError(f"kernel_precision must be 'f32', 'bf16' or "
                         f"'mixed', got {kernel_precision!r}")
    if mixed_tail_iters is not None and kernel_precision != "mixed":
        raise ValueError("mixed_tail_iters requires "
                         "kernel_precision='mixed'")
    # the kernel takes a scalar l1 threshold; the per-sample-alpha rescale
    # turns l1_alpha into an [N, 1] column, which takes the unfused path
    fusable = (supports_fused_group_step(x, z0, weight, n_groups)
               and l1_arr.ndim == 0)
    fused = resolve_pallas(use_pallas, fusable, x.device)
    S = _fuse_steps(fuse_steps, fused, maxiter, verbose)

    if fused and S > 1:
        x, z0, weight = x.contiguous(), z0.contiguous(), weight.contiguous()
        thg_row = (_f32(alpha) * lr).to(x.device) * (
            torch.ones((n_groups,), dtype=torch.float32, device=x.device)
            if w_row is None else w_row)
        l1_th = _f32(l1_alpha) * lr
    # ---------------------------------------------------------------------

    def rss_grad(z_k):
        resid = matmul(z_k, weight.T, prec) - x
        return matmul(resid, weight, prec)

    def loss_print(z):
        lv = group_lasso_objective(x, weight, z, alpha, groups,
                                   weights=group_weights,
                                   l1_alpha=l1_alpha,
                                   precision=precision) / x.shape[0]
        print(f"loss: {float(lv):.4f}")

    if restart:
        if not fast:
            raise ValueError("restart=True requires fast=True")
        t_vec = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                            device=x.device)
        z, z_prev, k, done = z0, z0, 0, False

        if fused and S > 1:
            def run_rm(kp, limit, steps):
                nonlocal z, z_prev, t_vec, k, done
                while not done and k + steps <= limit:
                    z, z_prev, t_vec, delta = fused_group_fista_multistep(
                        x, z, z_prev, weight, lr, thg_row, l1_th,
                        torch.zeros((steps,)), tables, steps=steps,
                        kernel_precision=kp, t_vec=t_vec, use_l1=use_l1)
                    done = float(psum(delta, axis_name)) <= tol_total
                    k += steps

            if kernel_precision == "mixed":
                # full S-blocks and one remainder block per phase, the
                # per-row t-vector carried across the phase switch
                tail_iters = _resolve_tail_iters(
                    mixed_tail, mixed_tail_iters, maxiter, S)
                n_bf16 = maxiter - tail_iters
                run_rm("bf16", n_bf16, S)
                r1 = n_bf16 % S
                if r1:
                    run_rm("bf16", n_bf16, r1)
                done = False
                S_t = min(S, tail_iters)
                r2 = tail_iters % S_t
                run_rm("f32", maxiter - r2, S_t)
                if r2:
                    run_rm("f32", maxiter, r2)
            else:
                run_rm(kernel_precision, maxiter, S)

        while not done and k < maxiter:
            if verbose:
                loss_print(z)
            t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t_vec * t_vec)) * 0.5
            y = z + ((t_vec - 1.0) / t_next) * (z - z_prev)
            z_new = prox(y - lr * rss_grad(y), lr)
            rdot = torch.sum((y - z_new) * (z_new - z), dim=1, keepdim=True)
            t_vec = torch.where(rdot > 0, 1.0, t_next)
            delta = torch.sum(torch.abs(z_new - z))
            z, z_prev, k = z_new, z, k + 1
            done = float(psum(delta, axis_name)) <= tol_total
        return (z, k) if return_iters else z

    one, zero = _f32(1.0), _f32(0.0)
    z, z_prev, t, mom, k, done = z0, z0, one, zero, 0, False

    if fused and S > 1:
        def run_blocks(kp, limit, steps):
            nonlocal z, z_prev, t, mom, k, done
            while not done and k + steps <= limit:
                # unroll the (data-independent) t/momentum recurrence
                mom_list = []
                t_c, m_c = t, mom
                for _ in range(steps):
                    mom_list.append(m_c)
                    if fast:
                        t_n = (1 + torch.sqrt(1 + 4 * t_c * t_c)) / 2
                        m_c = (t_c - 1) / t_n
                        t_c = t_n
                z, z_prev, delta = fused_group_fista_multistep(
                    x, z, z_prev, weight, lr, thg_row, l1_th,
                    torch.stack(mom_list), tables, steps=steps,
                    kernel_precision=kp, use_l1=use_l1)
                done = float(psum(delta, axis_name)) <= tol_total
                t, mom, k = t_c, m_c, k + steps

        if kernel_precision == "mixed":
            # full S-blocks and one remainder block per phase (sub-block
            # f32 tails via mixed_tail_iters, as in ista)
            tail_iters = _resolve_tail_iters(mixed_tail, mixed_tail_iters,
                                             maxiter, S)
            n_bf16 = maxiter - tail_iters
            run_blocks("bf16", n_bf16, S)
            r1 = n_bf16 % S
            if r1:
                run_blocks("bf16", n_bf16, r1)
            # the bf16 phase's verdict is bf16-grade: the f32 tail always
            # runs (never stops earlier than an all-f32 run)
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
            loss_print(z)
        y = z + mom * (z - z_prev)
        z_next = prox(y - lr * rss_grad(y), lr)
        delta = torch.sum(torch.abs(z - z_next))
        if fast:
            t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
            mom = (t - 1) / t_next
            t = t_next
        z, z_prev, k = z_next, z, k + 1
        done = float(psum(delta, axis_name)) <= tol_total

    return (z, k) if return_iters else z
