"""Implicit differentiation through the conv lasso solution.

Counterpart of the JAX package's ``conv2d/implicit.py``. The math is that
of :mod:`lasso_tpu_torch.linear.implicit` with the dictionary product
replaced by the adjoint conv pair ``A = conv_transpose2d(., W)``, ``A^T =
conv2d(., W)``. At an (a.e. unique-support) solution the KKT system on the
support S is

    c(z_S; x, W, alpha) = A^T(A z - x)|_S + alpha * sign(z_S) = 0

and every VJP flows through one solve with the support-restricted conv
normal operator ``H = mask * A^T A * mask``:

    u         = H^{-1} (zbar * mask)          (masked per-sample CG)
    x_bar     = conv_transpose2d(u, W)        (A u)
    W_bar     = -vjp_W[ A^T_W (A_W z - x) ](u)
    alpha_bar = -sum u * sign(z)              (reduced to alpha's shape)

W occurs twice in ``A^T_W (A_W z - x)``, so W_bar has two terms, each a
weight gradient of one convolution: ``-(adj(R, u) + adj(x_bar, z))`` with
``R = A z - x`` and ``adj(a, b)`` the gradient of ``<conv2d(a, V), b>`` in
V (the conv twin of ``-(R^T u + W (u^T z))``). The encoder is a
``torch.autograd.Function`` whose forward runs :func:`ista_conv2d` with no
graph; on a CUDA tensor at stride 1 in float32 that is the fused route.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from lasso_tpu_torch.conv2d.ista import ista_conv2d
from lasso_tpu_torch.conv2d.ops import (_code_shape, _conv2d_weight, conv2d,
                                        conv_transpose2d)
from lasso_tpu_torch.linalg.conjgrad import conjgrad_per_row
from lasso_tpu_torch.linear.implicit import _as_alpha
from lasso_tpu_torch.ops.common import (per_feature_alpha_row,
                                        per_sample_alpha_column)


def make_implicit_conv_encoder(support_eps=1e-7, ridge=0.0, cg_iters=200,
                               cg_tol=1e-12, stride=1, padding=0,
                               **solver_kwargs):
    """Build ``encode(x, kernel, alpha, z0=None) -> z`` differentiable in
    all three arguments by the implicit function theorem.

    The forward runs :func:`ista_conv2d` from zero codes (``solver_kwargs``
    go to it: run it tight, e.g. ``maxiter=500, tol=0.0``); the backward
    never differentiates through the solver loop. Layouts as the solver's:
    x ``[N, C_x, H, W]``, kernel ``[C_z, C_x, kh, kw]``, codes ``[N, C_z,
    H_z, W_z]``. ``alpha`` may be a scalar, per-sample ``[N]`` / ``[N,
    1]``, or per-channel ``(1, C_z)`` (bare ``(C_z,)`` when ``C_z != N``);
    its gradient comes back in its shape. ``ridge`` adds Tikhonov
    stabilization to the support Hessian. ``z0`` warm-starts the forward;
    its gradient is zero, returned as None.
    """
    def conv_pair(a, kernel):
        return conv2d(conv_transpose2d(a, kernel, stride=stride,
                                       padding=padding),
                      kernel, stride=stride, padding=padding)

    class Encode(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, kernel, alpha, z0):
            z = ista_conv2d(x, z0, kernel, alpha, stride=stride,
                            padding=padding, **solver_kwargs)
            ctx.save_for_backward(x, kernel, alpha, z)
            return z

        @staticmethod
        @once_differentiable
        def backward(ctx, zbar):
            x, kernel, alpha, z = ctx.saved_tensors
            need_x, need_w, need_a = ctx.needs_input_grad[:3]
            mask = (torch.abs(z) > support_eps).to(z.dtype)

            def Adot(u):
                um = u * mask
                Hu = conv_pair(um, kernel)
                if ridge:
                    Hu = Hu + ridge * um
                return mask * Hu

            def dot(a, c):
                return torch.sum(a * c, dim=(1, 2, 3), keepdim=True)

            u = conjgrad_per_row(zbar * mask, Adot, dot,
                                 maxiter=cg_iters, tol=cg_tol) * mask
            x_bar = W_bar = a_bar = None
            if need_x or need_w:
                x_bar = conv_transpose2d(u, kernel, stride=stride,
                                         padding=padding)
            if need_w:
                R = conv_transpose2d(z, kernel, stride=stride,
                                     padding=padding) - x
                W_bar = -(_conv2d_weight(R, u, kernel.shape, stride,
                                         padding)
                          + _conv2d_weight(x_bar, z, kernel.shape, stride,
                                           padding))
            if need_a:
                ds = -u * torch.sign(z)
                n, c_z = x.shape[0], z.shape[1]
                if alpha.ndim == 0:
                    a_bar = torch.sum(ds)
                elif per_feature_alpha_row(alpha, c_z, n) is not None:
                    a_bar = torch.sum(ds, dim=(0, 2, 3)).reshape(alpha.shape)
                elif per_sample_alpha_column(alpha, n) is not None:
                    a_bar = torch.sum(ds, dim=(1, 2, 3)).reshape(alpha.shape)
                else:
                    raise ValueError(
                        f"unsupported alpha shape {tuple(alpha.shape)}")
                a_bar = a_bar.to(alpha.dtype)
            return x_bar if need_x else None, W_bar, a_bar, None

    def encode(x, kernel, alpha, z0=None):
        if z0 is None:
            z0 = x.new_zeros(_code_shape(x.shape, kernel.shape, stride,
                                         padding))
        return Encode.apply(x, kernel, _as_alpha(alpha, x), z0)

    return encode


def implicit_conv_encode(x, kernel, alpha, support_eps=1e-7, ridge=0.0,
                         cg_iters=200, cg_tol=1e-12, stride=1, padding=0,
                         **solver_kwargs):
    """One-shot form of :func:`make_implicit_conv_encoder`."""
    enc = make_implicit_conv_encoder(
        support_eps=support_eps, ridge=ridge, cg_iters=cg_iters,
        cg_tol=cg_tol, stride=stride, padding=padding, **solver_kwargs)
    return enc(x, kernel, alpha)
