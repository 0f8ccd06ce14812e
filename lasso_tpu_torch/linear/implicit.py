"""Implicit differentiation through the lasso solution.

Counterpart of the JAX package's ``linear/implicit.py``: each encoder is a
``torch.autograd.Function`` whose forward runs a solver with no graph and
whose backward solves the support-restricted KKT system. At an (a.e.
unique-support) solution the support S pins z_S as an implicit function of
(x, W, alpha):

    c(z_S; x, W, alpha) = W_S^T (W_S z_S - x) + alpha * sign(z_S) = 0

so for a cotangent zbar every VJP flows through one linear solve with the
restricted Gram H_SS = W_S^T W_S:

    u_S       = H_SS^{-1} zbar_S                  (off-support u = 0)
    x_bar     = u W^T                             ([N, D])
    W_bar     = -(R^T u + W (u^T z))              ([D, K]; R = z W^T - x)
    alpha_bar = -sum u * sign(z)                  (reduced to alpha's shape)

The solve is matrix-free masked CG with per-row stops
(:func:`~lasso_tpu_torch.linalg.conjgrad.conjgrad_per_row`, one host read
an iteration), so nothing ``[N, K, K]``-sized is built. The products run
at the library's default precision ('highest': FP32, TF32 off).

Caveats: the map is differentiable wherever the support is locally
constant; at a support boundary the gradient is the one-sided limit. For
an overcomplete W with support size above D, H_SS is singular: CG returns
the best-residual u, and ``ridge`` adds Tikhonov stabilization.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.conjgrad import conjgrad_per_row
from lasso_tpu_torch.linear.solvers.group_lasso import (_group_ids,
                                                        group_ista,
                                                        resolve_groups)
from lasso_tpu_torch.linear.sparse_encode import sparse_encode
from lasso_tpu_torch.ops.common import matmul, row_dot


def _as_alpha(alpha, x):
    """``alpha`` as a tensor on x's device and dtype (a tensor keeps its
    graph)."""
    if torch.is_tensor(alpha):
        return alpha.to(device=x.device, dtype=x.dtype)
    return torch.as_tensor(alpha, dtype=x.dtype, device=x.device)


def _support_linear_solve(weight, mask, b, ridge, cg_iters, cg_tol, prec):
    """Solve ``H_SS u_S = b_S`` per sample by matrix-free masked CG.

    mask: ``[N, K]`` 0/1 support indicator; b: ``[N, K]`` (already
    masked). Returns u ``[N, K]``, zero off the support; a near-singular
    row freezes at its best iterate rather than poisoning the batch.
    """
    def Adot(u):
        um = u * mask
        Hu = matmul(matmul(um, weight.T, prec), weight, prec)
        if ridge:
            Hu = Hu + ridge * um
        return mask * Hu

    u = conjgrad_per_row(b, Adot, row_dot, maxiter=cg_iters, tol=cg_tol)
    return u * mask


def _dictionary_vjps(ctx, x, weight, z, u, prec):
    """``x_bar = u W^T`` and ``W_bar = -(R^T u + W (u^T z))`` (R = z W^T -
    x), each None unless asked for."""
    need_x, need_w = ctx.needs_input_grad[:2]
    x_bar = W_bar = None
    if need_x:
        x_bar = matmul(u, weight.T, prec)                          # [N, D]
    if need_w:
        R = matmul(z, weight.T, prec) - x                          # [N, D]
        W_bar = -(matmul(R.T, u, prec)
                  + matmul(weight, matmul(u.T, z, prec), prec))    # [D, K]
    return x_bar, W_bar


def _alpha_bar(ds, alpha):
    """``sum(ds)`` reduced to alpha's shape: a scalar, per-sample ``[N]`` or
    ``[N, 1]``, or a per-feature ``[1, K]`` row."""
    if alpha.ndim == 0:
        a_bar = torch.sum(ds)
    elif alpha.ndim == 1:                                          # [N]
        a_bar = torch.sum(ds, dim=1)
    elif alpha.shape[0] == 1:                                      # [1, K]
        a_bar = torch.sum(ds, dim=0, keepdim=True)
    else:                                                          # [N, 1]
        a_bar = torch.sum(ds, dim=1, keepdim=True)
    return a_bar.to(alpha.dtype)


def make_implicit_encoder(algorithm="ista", support_eps=1e-7, ridge=0.0,
                          cg_iters=200, cg_tol=1e-12, **solver_kwargs):
    """Build ``encode(x, weight, alpha, z0=None) -> z`` differentiable in
    x, weight and alpha by the implicit function theorem.

    The forward is :func:`sparse_encode` (any ``algorithm``;
    ``solver_kwargs`` go to it: run it tight, since the gradients assume
    an optimum). The backward solves the support-restricted normal
    equations by masked CG (``cg_iters``, ``cg_tol``), whatever the
    forward took. ``support_eps`` is the |z| threshold of the support;
    ``ridge`` a Tikhonov term for heavily overcomplete dictionaries.
    ``alpha`` may be a scalar, per-sample ``[N]`` / ``[N, 1]`` or a
    per-feature ``[1, K]`` row; its gradient comes back in its shape. An
    elastic-net ``l2`` in ``solver_kwargs`` enters the support Hessian as
    a ridge. ``z0`` warm-starts the forward; its gradient is zero (the
    optimum does not depend on it), returned as None.
    """
    prec = get_precision(None)
    ridge = ridge + float(solver_kwargs.get("l2", 0.0))

    class Encode(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, alpha, z0):
            z = sparse_encode(x, weight, alpha, z0=z0, algorithm=algorithm,
                              **solver_kwargs)
            ctx.save_for_backward(x, weight, alpha, z)
            return z

        @staticmethod
        @once_differentiable
        def backward(ctx, zbar):
            x, weight, alpha, z = ctx.saved_tensors
            mask = (torch.abs(z) > support_eps).to(z.dtype)
            u = _support_linear_solve(weight, mask, zbar * mask, ridge,
                                      cg_iters, cg_tol, prec)
            x_bar, W_bar = _dictionary_vjps(ctx, x, weight, z, u, prec)
            a_bar = (_alpha_bar(-u * torch.sign(z), alpha)
                     if ctx.needs_input_grad[2] else None)
            return x_bar, W_bar, a_bar, None

    def encode(x, weight, alpha, z0=None):
        if z0 is None:
            z0 = x.new_zeros((x.shape[0], weight.shape[1]))
        return Encode.apply(x, weight, _as_alpha(alpha, x), z0)

    return encode


def make_implicit_group_encoder(groups, group_weights=None, l1_alpha=0.0,
                                support_eps=1e-7, ridge=0.0, cg_iters=200,
                                cg_tol=1e-12, **solver_kwargs):
    """Build ``encode(x, weight, alpha, z0=None) -> z`` for the group lasso
    / sparse-group lasso, differentiable in x, weight and alpha by the
    implicit function theorem.

    Forward: :func:`~lasso_tpu_torch.linear.solvers.group_ista`
    (``groups``, ``group_weights`` and ``l1_alpha`` as there;
    ``solver_kwargs`` go to it). Backward: on the coordinate support S the
    KKT system

        W_S^T (W_S z - x) + alpha * w_g * z_g / ||z_g|| + l1 sign(z_S) = 0

    has the Jacobian ``H = W_S^T W_S + alpha * sum_g w_g B_g`` with the
    group-norm curvature ``B_g = (I - n_g n_g^T) / ||z_g||``, ``n_g = z_g
    / ||z_g||``, applied matrix-free through one-hot membership products.
    The VJPs are those of :func:`make_implicit_encoder` with ``alpha_bar =
    -sum u * w_g * n``. ``alpha`` may be a scalar or per-sample ``[N]``:
    ``group_ista`` refuses a 2-D alpha with ``ValueError``, an ``[N, 1]``
    too, as the JAX package's does. ``l1_alpha`` and ``group_weights`` are
    constants.
    """
    prec = get_precision(None)

    def _member(K, like):
        kind, data, n_groups = resolve_groups(groups, K)
        ids = _group_ids(kind, data, n_groups)
        member = np.zeros((K, n_groups), np.float32)
        member[np.arange(K), ids] = 1.0
        gw = (group_weights.cpu() if torch.is_tensor(group_weights)
              else group_weights)
        w = (np.ones((n_groups,), np.float32) if gw is None
             else np.asarray(gw, np.float32))
        return (torch.from_numpy(member).to(like),
                torch.from_numpy(w).to(like))

    class Encode(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, alpha, z0):
            z = group_ista(x, z0, weight, alpha, groups=groups,
                           group_weights=group_weights, l1_alpha=l1_alpha,
                           **solver_kwargs)
            ctx.save_for_backward(x, weight, alpha, z)
            return z

        @staticmethod
        @once_differentiable
        def backward(ctx, zbar):
            x, weight, alpha, z = ctx.saved_tensors
            member, w_g = _member(weight.shape[1], z)
            mask = (torch.abs(z) > support_eps).to(z.dtype)
            a_col = alpha if alpha.ndim == 0 else alpha.reshape(-1, 1)

            def hp(m):                       # [N, G] -> [N, K]
                return matmul(m, member.T, prec)

            def gsum(v):                     # [N, K] -> [N, G]
                return matmul(v, member, prec)

            norms_g = torch.sqrt(gsum(torch.square(z)))            # [N, G]
            act = norms_g > support_eps
            inv_n = torch.where(act, 1.0 / torch.where(act, norms_g, 1.0),
                                0.0)
            n_dir = z * hp(inv_n)                                  # unit dirs
            w_coord = hp(w_g[None, :])                             # [1, K]

            def Adot(u):
                um = u * mask
                Hu = matmul(matmul(um, weight.T, prec), weight, prec)
                # group-norm curvature: w_g/||z_g|| (u_g - n_g <n_g, u_g>)
                proj = n_dir * hp(gsum(n_dir * um))
                Hu = Hu + a_col * w_coord * hp(inv_n) * (um - proj)
                if ridge:
                    Hu = Hu + ridge * um
                return mask * Hu

            u = conjgrad_per_row(zbar * mask, Adot, row_dot,
                                 maxiter=cg_iters, tol=cg_tol) * mask
            x_bar, W_bar = _dictionary_vjps(ctx, x, weight, z, u, prec)
            a_bar = (_alpha_bar(-u * w_coord * n_dir, alpha)
                     if ctx.needs_input_grad[2] else None)
            return x_bar, W_bar, a_bar, None

    def encode(x, weight, alpha, z0=None):
        if z0 is None:
            z0 = x.new_zeros((x.shape[0], weight.shape[1]))
        return Encode.apply(x, weight, _as_alpha(alpha, x), z0)

    return encode


def implicit_sparse_encode(x, weight, alpha, algorithm="ista",
                           support_eps=1e-7, ridge=0.0, cg_iters=200,
                           cg_tol=1e-12, **solver_kwargs):
    """One-shot form of :func:`make_implicit_encoder`: a
    :func:`sparse_encode` call whose output carries implicit-function-
    theorem gradients with respect to ``x``, ``weight`` and ``alpha``."""
    enc = make_implicit_encoder(algorithm=algorithm,
                                support_eps=support_eps, ridge=ridge,
                                cg_iters=cg_iters, cg_tol=cg_tol,
                                **solver_kwargs)
    return enc(x, weight, alpha)
