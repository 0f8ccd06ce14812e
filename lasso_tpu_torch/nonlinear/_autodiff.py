"""Derivatives in the codes alone, for the nonlinear solvers.

The JAX package differentiates pure functions with ``jax.grad``,
``jax.jvp`` and ``jax.vjp``. Here a decoder is any torch callable, a plain
function or an ``nn.Module``, whose parameters may require gradients. Each
helper differentiates with ``torch.autograd.grad`` with respect to a
detached copy of its point alone, under ``torch.enable_grad()``, so that a
caller inside ``torch.no_grad()`` still gets its derivatives, no
parameter's ``.grad`` is touched, and what comes back carries no graph. A
graph built for repeated products lives as long as the closure that holds
it, never from one solver iteration to the next.
"""

from __future__ import annotations

import torch


def value_and_grad(fun, z):
    """``fun(z)`` and the gradient of its sum in ``z`` (a per-row loss
    ``[B]`` is differentiated as the batch's sum, as the JAX package's
    ``jax.grad(lambda z: jnp.sum(fun_vec(z)))``)."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_()
        f = fun(zz)
        (g,) = torch.autograd.grad(f.sum(), zz)
    return f.detach(), g


def hvp_at(fun, z):
    """``v -> H v``, H the Hessian of ``sum(fun)`` at ``z``. The gradient's
    graph is built once; each product is one backward pass through it
    (the JAX package's forward-over-reverse ``jvp(grad(fun))``; H is
    symmetric, so reverse-over-reverse gives the same product)."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_()
        (g,) = torch.autograd.grad(fun(zz).sum(), zz, create_graph=True)

    def hvp(v):
        (hv,) = torch.autograd.grad(g, zz, v, retain_graph=True)
        return hv

    return hvp


def linearize(fun, x):
    """``fun(x)`` and the closures ``v -> J v`` and ``w -> J^T w`` of its
    Jacobian J at ``x``, both on graphs built once. ``J v`` is the
    transpose of the vector-Jacobian product taken as a function of its
    cotangent (a backward pass through the backward graph), so ``fun``
    needs no forward-mode derivatives."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        fv = fun(xx)
        w = torch.zeros_like(fv, requires_grad=True)
        (jtw,) = torch.autograd.grad(fv, xx, w, create_graph=True)

    def jvp(v):
        (jv,) = torch.autograd.grad(jtw, w, v, retain_graph=True)
        return jv

    def vjp(cot):
        (out,) = torch.autograd.grad(fv, xx, cot, retain_graph=True)
        return out

    return fv.detach(), jvp, vjp
