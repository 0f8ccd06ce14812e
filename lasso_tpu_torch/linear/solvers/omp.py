"""Batched Orthogonal Matching Pursuit.

Counterpart of the JAX package's ``linear/solvers/omp.py``: the greedy L0
encoder ``min_z ||z W^T - x||^2 s.t. ||z||_0 <= T`` with a fixed step
count, per-sample atom selection by a masked argmax on ``c = r W``, the
support kept as an [N, T] index matrix with a validity mask, and a
per-sample ``tol`` stop on the squared residual (sklearn's
``orthogonal_mp(tol=...)``) that freezes a finished sample exactly.

The four routes of the JAX package are ported:

* ``solver='fused'``: the whole solve as the kernels of
  :mod:`lasso_tpu_torch.ops.fused_omp` (QR-OMP by modified Gram-Schmidt);
* ``solver='chol'``: the incremental-Gram loop, which carries each sample's
  inverse Cholesky factor and appends one row a step with
  :func:`lasso_tpu_torch.ops.batched_cholesky.cholesky_append_solve_lanes`;
* ``solver='chol-full'``: the refactorizing loop, which carries each
  sample's [T, T] support system and solves it afresh every step with
  :func:`lasso_tpu_torch.linalg.batch_cholesky_solve` (the Cholesky solve
  kernel where it applies, an LU solve of the whole batch when a support
  system is not PD);
* ``solver='cg'``: the same refactorizing loop, with each step's support
  system solved by :func:`lasso_tpu_torch.linalg.conjgrad_per_row`,
  warm-started at the previous step's coefficients.

Their per-step products, gathers and argmax are PyTorch ops, as the JAX
package leaves them to XLA; the ``while_loop`` is a Python loop that reads
``any(active)`` to the host once a step ('cg' also once a CG iteration).
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.basic import batch_cholesky_solve
from lasso_tpu_torch.linalg.conjgrad import conjgrad_per_row
from lasso_tpu_torch.ops.batched_cholesky import (cholesky_append_solve_lanes,
                                                  supports_lanes_append)
from lasso_tpu_torch.ops.common import matmul, resolve_pallas, row_dot
from lasso_tpu_torch.ops.fused_omp import fused_omp_solve, supports_fused_omp

# N T^2 above which 'auto' takes 'cg' over 'chol-full' where the append
# kernel is unavailable: the refactorizing Cholesky stays ahead of the
# warm-started CG up to there in the JAX package's measurements
_CG_CROSSOVER = 1 << 27


def _scatter_codes(idx, z_s, K):
    """The [N, K] codes of supports idx [N, T] with coefficients z_s; the
    unused slots carry z_s = 0, so their index-0 adds change nothing."""
    z = torch.zeros((idx.shape[0], K), dtype=z_s.dtype, device=z_s.device)
    return z.scatter_add_(1, idx.long(), z_s)


def orthogonal_matching_pursuit(x, weight, n_nonzero_coefs=None, tol=None,
                                precision=None, gram_jitter=0.0,
                                solver="auto", cg_tol=1e-10,
                                use_pallas="auto", ws_fast="auto",
                                kernel_precision="f32",
                                verbose=False, return_iters=False):
    """Batched OMP. x: [N, D], weight W: [D, K] -> codes z: [N, K].

    ``n_nonzero_coefs``: the support budget T (default ``max(1, K // 10)``,
    at most ``min(D, K)``). ``tol``: optional per-sample stop on the
    squared residual norm. ``gram_jitter``: diagonal jitter of the support
    Gram solve ('chol', 'chol-full' and 'cg'). ``kernel_precision`` ('f32' or
    'bf16') sets the selection product of 'fused'. ``ws_fast``: the
    gather-free ``W_S``-carry loop body of 'chol' ('auto' while the
    [N, T, D] carry stays under 6 GB; True/False force it; both bodies
    compute the same recursion; 'chol-full' and 'cg' always gather).
    ``cg_tol``: the per-row residual tolerance of 'cg''s solves.

    ``solver``:

    * 'fused' runs :func:`lasso_tpu_torch.ops.fused_omp.fused_omp_solve`
      where :func:`supports_fused_omp` holds (D and K not multiples of 128
      are zero-padded onto it exactly) and ``verbose`` and ``gram_jitter``
      are off, on a CUDA tensor with ``use_pallas`` 'auto' or True, and on
      any tensor with True (the plain versions off the card). Unavailable,
      it warns and goes to 'auto'.
    * 'chol' appends to the carried inverse factor each step; available
      where :func:`supports_lanes_append` holds for T rounded up to a
      multiple of 8, unless ``use_pallas=False``. On a CUDA tensor it
      launches the append kernel, on a CPU tensor the plain version.
      Unavailable, it warns and takes 'chol-full', the exact route.
    * 'chol-full' refactorizes the support system each step with
      :func:`batch_cholesky_solve` (``use_pallas`` passed on).
    * 'cg' solves each step's [N, T, T] support system by
      :func:`conjgrad_per_row` (``maxiter=T+8``, ``tol=cg_tol``),
      warm-started at the previous step's coefficients.
    * 'auto' takes 'fused' where it is available, else 'chol' where the
      append kernel launches (a CUDA tensor, or ``use_pallas=True``),
      else 'chol-full' up to N T^2 = 2^27 and 'cg' above.

    Atom selection divides the correlations by the column norms (a no-op
    for unit-norm dictionaries). Returns ``z`` [N, K], plus the executed
    iteration count when ``return_iters``.
    """
    prec = get_precision(precision)
    N, D = x.shape
    K = weight.shape[1]
    if n_nonzero_coefs is None:
        n_nonzero_coefs = max(1, K // 10)
    T = int(n_nonzero_coefs)
    if not 0 < T <= min(D, K):
        raise ValueError(
            f"n_nonzero_coefs must be in [1, min(D, K)] = "
            f"[1, {min(D, K)}], got {T}")
    Tp = -(-T // 8) * 8          # the append kernel's panel-aligned T
    # Pad onto the fused path's 128-aligned (D, K) grid when only alignment
    # blocks it: zero feature columns change no correlation or residual,
    # and a zero atom scores |c_k| * invn_k = 0 exactly, so the masked
    # argmax never takes it and the [:, :K] slice is the same greedy solve.
    if (solver in ("auto", "fused") and not verbose and not gram_jitter
            and not supports_fused_omp(N, D, K, T, x.dtype)):
        Dp, Kp = -(-D // 128) * 128, -(-K // 128) * 128
        if ((Dp, Kp) != (D, K)
                and supports_fused_omp(N, Dp, Kp, T, x.dtype)
                and resolve_pallas(use_pallas, True, x.device)):
            out = orthogonal_matching_pursuit(
                F.pad(x, (0, Dp - D)), F.pad(weight, (0, Kp - K, 0, Dp - D)),
                n_nonzero_coefs=T, tol=tol, precision=precision,
                solver=solver, cg_tol=cg_tol, use_pallas=use_pallas,
                ws_fast=ws_fast, kernel_precision=kernel_precision,
                return_iters=return_iters)
            if return_iters:
                z_u, it = out
                return z_u[:, :K], it
            return out[:, :K]

    fused_on = resolve_pallas(
        use_pallas, supports_fused_omp(N, D, K, T, x.dtype)
        and not verbose and not gram_jitter, x.device)
    if solver == "fused" and not fused_on:
        warnings.warn(
            "solver='fused' requested but the fused OMP kernels are "
            "unavailable here (they need float32, 128-aligned D and K, "
            "verbose=False, gram_jitter=0, and a CUDA tensor or "
            "use_pallas=True); falling back to solver='auto'.", stacklevel=2)
        solver = "auto"
    if solver == "auto" and fused_on:
        solver = "fused"
    if solver == "fused":
        idx, valid, z_s = fused_omp_solve(x, weight, T, tol=tol,
                                          kernel_precision=kernel_precision)
        z = _scatter_codes(idx, z_s, K)
        if return_iters:
            return z, int(torch.max(torch.sum(valid, dim=1)))
        return z
    inc = bool(use_pallas) and supports_lanes_append(Tp, N, x.dtype)
    if solver == "auto" and not resolve_pallas(use_pallas, inc, x.device):
        solver = "cg" if N * T * T > _CG_CROSSOVER else "chol-full"
    elif solver == "chol" and not inc:
        # an explicit exact solver never remaps to the inexact CG
        warnings.warn(
            "solver='chol' requested but the incremental append kernel is "
            "unavailable here (needs float32 and use_pallas not False); "
            "falling back to the exact refactorizing 'chol-full' path.",
            stacklevel=2)
        solver = "chol-full"
    if solver == "auto":
        solver = "chol"
    if solver not in ("chol", "chol-full", "cg"):
        raise ValueError(f"solver must be 'fused', 'chol', 'chol-full', "
                         f"'cg' or 'auto', got {solver!r}")
    return _omp_chol(x, weight, T, Tp, tol, prec, gram_jitter, ws_fast,
                     verbose, return_iters, solver, use_pallas=use_pallas,
                     cg_tol=cg_tol)


def _omp_chol(x, weight, T, Tp, tol, prec, gram_jitter, ws_fast, verbose,
              return_iters, solver="chol", use_pallas="auto", cg_tol=1e-10):
    """The unfused routes (the JAX package's while_loop): the incremental
    'chol', or the refactorizing 'chol-full' and 'cg', which always take
    the gather body and solve their [N, T, T] system with
    :func:`batch_cholesky_solve` (``use_pallas``) or with
    :func:`conjgrad_per_row` warm-started at the last coefficients."""
    full = solver != "chol"
    N, D = x.shape
    K = weight.shape[1]
    dev, dtype = x.device, x.dtype
    G = matmul(weight.T, weight, prec)                        # [K, K]
    b = matmul(x, weight, prec)                               # [N, K]
    col_norm = torch.sqrt(torch.clamp(torch.diagonal(G), min=1e-30))
    rows = torch.arange(N, device=dev)
    wt = weight.T.contiguous()
    tol_v = (None if tol is None
             else torch.as_tensor(tol, dtype=dtype, device=dev))
    ek_all = torch.eye(Tp, dtype=dtype, device=dev)
    eyeT = torch.eye(T, dtype=dtype, device=dev)

    # the gather-free body carries the selected atoms W_S [N, T, D], so the
    # residual, the new Gram row and the new rhs entry are dense products;
    # past the 6 GB footprint the legacy gather body runs
    if full:
        ws_fast = False
    elif ws_fast == "auto":
        ws_fast = N * T * D * x.element_size() <= (6 << 30)
    else:
        ws_fast = bool(ws_fast)

    def select(idx, valid, sel, active, k, r):
        """The atom selection of one step from the residual; updates idx,
        valid and sel in place."""
        if tol_v is not None or verbose:
            rss = torch.sum(r * r, dim=1)                     # [N]
        if verbose:
            print(f"iter {k} - mean rss: {float(torch.mean(rss)):.6f}")
        if tol_v is not None:
            active = active & (rss > tol_v)
        c = matmul(r, weight, prec)                           # [N, K]
        score = torch.where(sel, -1.0, torch.abs(c) / col_norm)
        k_star = torch.argmax(score, dim=1)                   # first max
        sel[rows[active], k_star[active]] = True
        idx[:, k] = torch.where(active, k_star, 0).to(torch.int32)
        valid[:, k] = active
        w_sel = wt[k_star]                                    # [N, D]
        return idx, valid, sel, active, k_star, w_sel

    def append_solve(V, g_k, b_s, active, k):
        """Frozen samples append an identity row, which leaves their
        solution exactly as it was."""
        ek = ek_all[k]                                        # [Tp]
        g_k = F.pad(g_k, (0, Tp - T))
        if gram_jitter:
            g_k = g_k + gram_jitter * ek
        g_app = torch.where(active[:, None], g_k, ek)          # [N, Tp]
        gt = g_app.T.contiguous()
        bt = F.pad(b_s, (0, Tp - T)).T.contiguous()
        V, z_t = cholesky_append_solve_lanes(V, gt, bt, k, out=V)
        return V, z_t[:T].T

    idx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    valid = torch.zeros((N, T), dtype=torch.bool, device=dev)
    z_s = torch.zeros((N, T), dtype=dtype, device=dev)
    if full:
        sys = eyeT.repeat(N, 1, 1)                            # [N, T, T]
    else:
        V = torch.eye(Tp, dtype=dtype, device=dev)[:, :, None].repeat(1, 1, N)
    sel = torch.zeros((N, K), dtype=torch.bool, device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    if ws_fast:
        W_S = torch.zeros((N, T, D), dtype=dtype, device=dev)
        b_s = torch.zeros((N, T), dtype=dtype, device=dev)
    k = 0
    while k < T and bool(torch.any(active)):
        if ws_fast:
            r = x - matmul(z_s[:, None, :], W_S, prec)[:, 0]
            idx, valid, sel, active, k_star, w_sel = select(
                idx, valid, sel, active, k, r)
            W_S[:, k] = torch.where(active[:, None], w_sel, 0.0)
            # slot k lands |w_sel|^2 since W_S was updated first; frozen
            # and unused slots hold zero atoms, hence exact zeros
            g_row = matmul(W_S, w_sel[:, :, None], prec)[..., 0]  # [N, T]
            b_s[:, k] = torch.where(active, b[rows, k_star], 0.0)
            V, z_new = append_solve(V, g_row, b_s, active, k)
        else:
            r = x - matmul(_scatter_codes(idx, z_s, K), weight.T, prec)
            idx, valid, sel, active, _, w_sel = select(
                idx, valid, sel, active, k, r)
            g_full = matmul(w_sel, weight, prec)              # [N, K]
            g_row = torch.gather(g_full, 1, idx.long())
            b_sel = torch.where(valid, torch.gather(b, 1, idx.long()), 0.0)
            g_k = torch.where(valid, g_row, 0.0)
            if full:
                # a frozen sample's row and column k stay identity, so its
                # solution stays as it was
                row_k = torch.where(active[:, None], g_k, eyeT[k])
                sys[:, k, :] = row_k
                sys[:, :, k] = row_k
                G_sys = sys + gram_jitter * eyeT if gram_jitter else sys
                if solver == "chol-full":
                    z_new = batch_cholesky_solve(b_sel, G_sys,
                                                 use_pallas=use_pallas)
                else:
                    z_new = conjgrad_per_row(
                        b_sel, lambda u: matmul(G_sys, u[:, :, None],
                                                prec)[:, :, 0],
                        row_dot, maxiter=T + 8, tol=cg_tol, x0=z_s)
            else:
                V, z_new = append_solve(V, g_k, b_sel, active, k)
        z_s = torch.where(valid, z_new, 0.0)
        k += 1
    z = _scatter_codes(idx, z_s, K)
    if return_iters:
        return z, k
    return z
