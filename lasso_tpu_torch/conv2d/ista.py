"""Convolutional FISTA: sparse coding with a conv_transpose decoder.

Counterpart of the JAX package's ``conv2d/ista.py``. The decoder is ``x_hat =
conv_transpose2d(z, W)`` and the RSS gradient is ``conv2d(x_hat - x, W)``;
the automatic step size is the Araujo Toeplitz bound at stride 1 and the
power iteration of the conv normal operator otherwise.

z: [N, C_z, H_z, W_z], weight: [C_z, C_x, kh, kw], x: [N, C_x, H, W]

Python loops take the place of ``lax.while_loop``. The stopping test
``sum|dz| <= numel * tol`` is read to the host once per iteration on the
unfused route and once per fused block of ``fuse_steps`` iterations on the
fused route; the momentum recurrence is unrolled on the host in float32,
as the JAX package runs it in float32.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.conv2d.lip_const import lip_bound_conv2d, lip_constant
from lasso_tpu_torch.conv2d.ops import _pair, conv2d, conv_transpose2d
from lasso_tpu_torch.ops.common import (check_axis_name, global_tol,
                                        per_feature_alpha_row,
                                        per_sample_alpha_column, psum,
                                        resolve_pallas)
from lasso_tpu_torch.ops.fused_conv import (fused_conv_fista_multistep,
                                            max_fuse_steps_conv,
                                            supports_fused_conv)
from lasso_tpu_torch.ops.precision import round_bf16
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _fuse_steps(fuse_steps, weight, maxiter):
    """Iterations per fused call: 'auto' takes the largest divisor of
    ``maxiter`` <= min(16, :func:`max_fuse_steps_conv`), or 8 (capped)
    with a remainder block when that divisor is below 4."""
    if fuse_steps == "auto":
        s_cap = min(16, max_fuse_steps_conv(weight))
        S = next((s for s in range(min(s_cap, maxiter), 0, -1)
                  if maxiter % s == 0), 1)
        if S < 4 <= s_cap:
            S = min(8, maxiter, s_cap)
    else:
        S = max(1, int(fuse_steps))
    return min(S, maxiter)


def _ista_conv2d_fused(x, z0, weight, alpha, padding, maxiter, lr,
                       tol_total, phases, fuse_steps, nonneg, restart,
                       axis_name=None):
    """The fused route of :func:`ista_conv2d` (stride 1): each phase (one
    for 'f32'/'bf16', a bf16 bulk and an f32 tail for 'mixed') runs full
    ``S``-iteration blocks, then one remainder block of its own size.
    Returns ``(z, n_iter)``."""
    pad = _pair(padding)[0]
    S = _fuse_steps(fuse_steps, weight, maxiter)
    x, z0, weight = x.contiguous(), z0.contiguous(), weight.contiguous()
    lr_f = _f32(lr).cpu()
    a = torch.as_tensor(alpha, dtype=torch.float32)
    ths = (a.to(x.device).reshape(weight.shape[0], 1) * lr_f.to(x.device)
           if a.ndim > 0 else lr_f * a.cpu())
    z, z_prev, k, done = z0, z0, 0, False
    t = (torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
         if restart else _f32(1.0))
    mom = _f32(0.0)

    def run_blocks(mode, limit, steps):
        nonlocal z, z_prev, t, mom, k, done
        while not done and k + steps <= limit:
            if restart:
                # the per-sample t rides in the kernels; moms is ignored
                z, z_prev, t, delta = fused_conv_fista_multistep(
                    x, z, z_prev, weight, lr_f, ths, 0.0, steps,
                    padding=pad, kernel_precision=mode, nonneg=nonneg,
                    t_vec=t)
            else:
                mom_list, t_c, m_c = [], t, mom
                for _ in range(steps):
                    mom_list.append(m_c)
                    t_n = (1 + torch.sqrt(1 + 4 * t_c * t_c)) / 2
                    m_c = (t_c - 1) / t_n
                    t_c = t_n
                z, z_prev, delta = fused_conv_fista_multistep(
                    x, z, z_prev, weight, lr_f, ths, torch.stack(mom_list),
                    steps, padding=pad, kernel_precision=mode,
                    nonneg=nonneg)
                t, mom = t_c, m_c
            k += steps
            done = float(psum(delta, axis_name)) <= tol_total

    start = 0
    for idx, (mode, limit) in enumerate(phases):
        length = limit - start
        if length <= 0:
            start = limit
            continue
        Sb = min(S, length)
        r = length % Sb
        run_blocks(mode, limit - r, Sb)
        if r:
            run_blocks(mode, limit, r)
        if idx + 1 < len(phases):
            # a bf16 phase's convergence statistic is bf16-grade: the f32
            # tail always runs
            done = False
        start = limit
    return z, k


def ista_conv2d(x, z0, weight, alpha=1.0, stride=1, padding=0, fast=True,
                maxiter=10, lr="auto", tol=1e-5, restart=False,
                kernel_precision="f32", mixed_tail="auto", nonneg=False,
                use_pallas="auto", fuse_steps="auto",
                axis_name=None, verbose=False, return_iters=False):
    """Conv FISTA on the device of ``x``.

    * ``restart=True``: per-sample adaptive momentum restart (O'Donoghue
      and Candes): each sample carries its own t-sequence and resets it
      when its gradient-mapping test fires. Needs ``fast=True``.
    * ``kernel_precision``: 'f32' (default; FP32 convolutions, TF32 off),
      'bf16' (operands rounded to bf16, FP32 sums), or 'mixed' (a bf16
      bulk, then an f32 tail of ``mixed_tail`` iterations, 'auto' =
      max(1, maxiter // 8)); the bf16 phase's stopping verdict is
      discarded, so 'mixed' always runs its f32 tail.
    * ``alpha``: a scalar, an ``[N]`` vector of per-sample penalties
      (exact through the lasso's homogeneity), or a per-channel vector
      over the ``C_z`` code channels (``(1, C_z)`` always, bare ``(C_z,)``
      when ``C_z != N``).
    * ``use_pallas`` (the JAX package's name): 'auto' runs stride-1
      float32 problems on a CUDA tensor through the fused kernels of
      :mod:`lasso_tpu_torch.ops.fused_conv`, ``fuse_steps`` iterations a
      call; True takes that route whenever the shapes allow it (on the CPU
      the kernels' plain versions run); False always takes the unfused
      step. The fused route needs ``fast=True`` and no ``verbose``, and
      tests convergence only at block boundaries, so it never stops
      earlier than the unfused route would.
    * ``fuse_steps``: iterations a fused call; 'auto' takes the largest
      divisor of ``maxiter`` <= 16 (and <= the tap-row cap of
      :func:`lasso_tpu_torch.ops.fused_conv.max_fuse_steps_conv`), or 8
      with a remainder block.
    * ``verbose`` prints the lasso loss per iteration.
    * ``axis_name``: a ``torch.distributed.ProcessGroup`` whose ranks
      each hold images of one batch; the stopping sum and threshold are
      all-reduced over it, once a block (see
      :func:`lasso_tpu_torch.linear.solvers.ista`).

    Returns codes ``z``; with ``return_iters=True`` also the number of
    iterations executed (an int).
    """
    check_axis_name(axis_name)
    a_ch = per_feature_alpha_row(alpha, z0.shape[1], x.shape[0])
    if a_ch is not None:
        alpha = a_ch.to(dtype=x.dtype, device=x.device).reshape(
            1, z0.shape[1], 1, 1)
    a_col = (None if a_ch is not None else
             per_sample_alpha_column(alpha, x.shape[0], ndim=x.ndim))
    if a_col is not None:
        a_col = a_col.to(dtype=x.dtype, device=x.device)
        out = ista_conv2d(
            x / a_col, z0 / a_col, weight, 1.0, stride=stride,
            padding=padding, fast=fast, maxiter=maxiter, lr=lr, tol=tol,
            restart=restart, kernel_precision=kernel_precision,
            mixed_tail=mixed_tail, nonneg=nonneg, use_pallas=use_pallas,
            fuse_steps=fuse_steps, axis_name=axis_name, verbose=verbose,
            return_iters=return_iters)
        if return_iters:
            z_u, k = out
            return z_u * a_col, k
        return out * a_col

    if isinstance(lr, str):
        if lr != "auto":
            raise ValueError(f"invalid lr {lr!r}")
        if stride == 1:
            L = lip_bound_conv2d(weight, padding)
        else:
            # the Araujo bound needs stride 1: the power iteration of the
            # conv normal operator instead
            L = lip_constant(weight, imsize=z0.shape[-2:], stride=stride,
                             padding=padding)
        lr = 1.0 / L
    lr = _f32(lr).cpu()
    # delta (float32) is compared with numel * tol rounded to float32
    tol_total = global_tol(z0.numel(), tol, torch.float32, axis_name,
                           x.device)

    if kernel_precision not in ("f32", "bf16", "mixed"):
        raise ValueError(f"kernel_precision must be 'f32', 'bf16' or "
                         f"'mixed', got {kernel_precision!r}")
    # precision phases: (mode, iteration limit); 'mixed' = a bf16 bulk,
    # then an f32 tail resuming the carried state
    if kernel_precision == "mixed":
        if mixed_tail == "auto":
            tail = max(1, maxiter // 8)
        else:
            tail = int(mixed_tail)
            if tail < 1:
                raise ValueError(
                    f"mixed_tail must be >= 1 iteration, got {mixed_tail}")
        tail = min(tail, maxiter)
        phases = [("bf16", maxiter - tail), ("f32", maxiter)]
    else:
        phases = [(kernel_precision, maxiter)]

    fused = resolve_pallas(
        use_pallas, fast and not verbose
        and supports_fused_conv(x, z0, weight, stride, padding), x.device)
    if fused:
        z, k = _ista_conv2d_fused(x, z0, weight, alpha, padding, maxiter,
                                  lr, tol_total, phases, fuse_steps, nonneg,
                                  restart, axis_name)
        return (z, k) if return_iters else z

    w_bf16 = round_bf16(weight) if phases[0][0] == "bf16" else None

    def rss_grad(zk, mode):
        if mode == "bf16":
            x_hat = conv_transpose2d(round_bf16(zk), w_bf16, stride=stride,
                                     padding=padding, precision="default")
            return conv2d(round_bf16(x_hat - x), w_bf16, stride=stride,
                          padding=padding, precision="default")
        x_hat = conv_transpose2d(zk, weight, stride=stride, padding=padding)
        return conv2d(x_hat - x, weight, stride=stride, padding=padding)

    prox = soft_threshold_nonneg if nonneg else soft_threshold

    def step(zk, mode):
        return prox(zk - lr * rss_grad(zk, mode), alpha * lr)

    def print_loss(zk):
        x_hat = conv_transpose2d(zk, weight, stride=stride, padding=padding)
        loss = (0.5 * torch.sum(torch.square(x_hat - x))
                + torch.sum(alpha * torch.abs(zk)))
        print(f"loss: {float(loss):.4f}")

    if restart:
        if not fast:
            raise ValueError("restart=True requires fast=True")
        z, z_prev, k = z0, z0, 0
        t_vec = torch.zeros((x.shape[0], 1, 1, 1), dtype=x.dtype,
                            device=x.device)
        for mode, limit in phases:
            done = False
            while not done and k < limit:
                if verbose:
                    print_loss(z)
                t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t_vec * t_vec)) * 0.5
                y = z + ((t_vec - 1.0) / t_next) * (z - z_prev)
                z_new = step(y, mode)
                rdot = torch.sum((y - z_new) * (z_new - z), dim=(1, 2, 3),
                                 keepdim=True)
                t_vec = torch.where(rdot > 0, 1.0, t_next)
                done = float(psum(torch.sum(torch.abs(z_new - z)),
                                  axis_name)) <= tol_total
                z, z_prev, k = z_new, z, k + 1
        return (z, k) if return_iters else z

    z, y, t, k = z0, z0, _f32(1.0), 0
    for mode, limit in phases:
        # a bf16 phase's verdict is discarded: each phase starts undone
        done = False
        while not done and k < limit:
            if verbose:
                print_loss(z)
            z_next = step(y, mode) if fast else step(z, mode)
            if fast:
                t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
                y_next = z_next + ((t - 1) / t_next) * (z_next - z)
            else:
                t_next, y_next = t, z_next
            done = float(psum(torch.sum(torch.abs(z_next - z)),
                              axis_name)) <= tol_total
            z, y, t, k = z_next, y_next, t_next, k + 1
    return (z, k) if return_iters else z
