"""Implicit differentiation through the nonlinear lasso solution.

Counterpart of the JAX package's ``nonlinear/implicit.py``: sparse coding
through a differentiable decoder becomes a layer differentiable in the
observations ``x``, the decoder's parameters and ``alpha``. With ``f(z;
params, x) = 0.5 ||decoder(params, z) - x||^2`` and ``g = grad_z f``, at an
(a.e. unique-support) solution the KKT system on the support S is ``g(z)|_S
+ alpha sign(z_S) = 0``, and for a cotangent zbar every VJP flows through
one solve with the support-restricted Hessian ``H = mask * grad^2_z f *
mask``:

    u          = H^{-1} (zbar * mask)       (masked per-row CG)
    x_bar      = -vjp_x[g](u)
    params_bar = -vjp_params[g](u)
    alpha_bar  = -sum u * sign(z)           (reduced to alpha's shape)

The Hessian is never formed: the gradient g is built once with its graph,
each CG product ``H u`` is one backward pass through it, and the mixed
second derivatives one more. The CG is
:func:`~lasso_tpu_torch.linalg.conjgrad.conjgrad_per_row` (one host read an
iteration): a row at an indefinite point freezes at its best iterate, and
``ridge`` adds Levenberg-style stabilization.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable
from torch.utils._pytree import tree_flatten, tree_unflatten

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.linalg.conjgrad import conjgrad_per_row
from lasso_tpu_torch.linear.implicit import _alpha_bar, _as_alpha
from lasso_tpu_torch.nonlinear.ista import ista_nl
from lasso_tpu_torch.ops.common import row_dot


def _flatten(params):
    """The tensors of a parameter tree and its structure (None: none)."""
    return ([], None) if params is None else tree_flatten(params)


def _unflatten(leaves, spec):
    return None if spec is None else tree_unflatten(list(leaves), spec)


def make_implicit_nl_encoder(decoder, support_eps=1e-7, ridge=0.0,
                             cg_iters=100, cg_tol=1e-12, **solver_kwargs):
    """Build ``encode(x, params, alpha) -> z``, differentiable in all three
    by the implicit function theorem.

    ``decoder(params, z) -> x_hat``, ``params`` a dict, list or tuple of
    tensors (nested), a single tensor, or None with a closure for a decoder
    without parameters; their gradients come back in the same structure.
    The forward is :func:`~lasso_tpu_torch.nonlinear.ista.ista_nl` with
    the decoder bound to ``params``; ``solver_kwargs`` go to it, and ``z0``
    is required among them (a constant, not differentiated): run the
    forward tight, since the gradients assume an optimum. ``alpha`` may be
    a scalar, a per-sample ``[N, 1]`` column or a per-feature ``[1, K]``
    row.
    """
    z0_fixed = solver_kwargs.pop("z0", None)
    if z0_fixed is None:
        raise ValueError("make_implicit_nl_encoder requires z0 (the "
                         "nonlinear solver has no canonical zero-code "
                         "shape inference)")

    class Encode(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, alpha, spec, *leaves):
            params = _unflatten(leaves, spec)
            z = ista_nl(x, z0_fixed, lambda zz: decoder(params, zz),
                        alpha=alpha, **solver_kwargs)
            ctx.spec = spec
            ctx.save_for_backward(x, alpha, z, *leaves)
            return z

        @staticmethod
        @once_differentiable
        def backward(ctx, zbar):
            x, alpha, z, *leaves = ctx.saved_tensors
            if z.is_cuda:
                require_fp32_matmul()
            mask = (torch.abs(z) > support_eps).to(z.dtype)
            with torch.enable_grad():
                zz = z.detach().requires_grad_()
                xx = x.detach().requires_grad_()
                ll = [leaf.detach().requires_grad_() for leaf in leaves]
                r = decoder(_unflatten(ll, ctx.spec), zz) - xx
                (g,) = torch.autograd.grad(0.5 * torch.sum(r * r), zz,
                                           create_graph=True)

            def Adot(u):
                um = u * mask
                (Hu,) = torch.autograd.grad(g, zz, um, retain_graph=True)
                if ridge:
                    Hu = Hu + ridge * um
                return mask * Hu

            u = conjgrad_per_row(zbar * mask, Adot, row_dot,
                                 maxiter=cg_iters, tol=cg_tol) * mask
            bars = torch.autograd.grad(g, [xx, *ll], u, allow_unused=True)
            bars = [torch.zeros_like(v) if b is None else -b
                    for v, b in zip([xx, *ll], bars)]
            a_bar = (_alpha_bar(-u * torch.sign(z), alpha)
                     if ctx.needs_input_grad[1] else None)
            return bars[0], a_bar, None, *bars[1:]

    def encode(x, params, alpha):
        leaves, spec = _flatten(params)
        return Encode.apply(x, _as_alpha(alpha, x), spec, *leaves)

    return encode
