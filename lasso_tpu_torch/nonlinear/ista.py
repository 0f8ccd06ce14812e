"""Nonlinear FISTA: sparse coding through a differentiable decoder.

Counterpart of the JAX package's ``nonlinear/ista.py``. The decoder is any
torch callable ``z -> x_hat``, a plain function or an ``nn.Module``;
gradients are taken in the codes alone (``nonlinear/_autodiff.py``), so a
module's parameters are never written and no graph outlives an iteration.

* The RSS gradient is ``torch.autograd.grad`` of the residual loss.
* The per-sample step 0.98 / L takes L, the Hessian's 2-norm, by power
  iteration on Hessian-vector products: the gradient's graph is built once
  a refresh and each product is one backward pass through it.
* Each loop reads its stopping test to the host once an iteration (one
  synchronization on a CUDA tensor), as the port's linear ``ista`` does.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.nonlinear._autodiff import hvp_at, value_and_grad
from lasso_tpu_torch.ops.common import check_axis_name, global_tol, psum
from lasso_tpu_torch.ops.shrink import soft_threshold

softshrink = soft_threshold  # the non-scalar-theta variant


def _normalize(v, dims):
    n = torch.sqrt(torch.sum(torch.square(v), dim=dims, keepdim=True))
    return v / (n + 1e-8)


def _normal(shape, like, generator):
    """A standard normal draw of ``shape`` on ``like``'s device and dtype
    from ``generator`` (seed 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _feature_dims(x):
    return tuple(range(1, x.ndim))


@torch.no_grad()
def hessian_2norm(fun, x, niter=10, generator=None, u0=None,
                  return_vector=False):
    """Per-sample Hessian 2-norm of a scalar ``fun`` by power iteration.
    ``x``: ``[B, ...]``; returns ``[B]``.

    The start is ``u0`` or a normalized standard normal draw from
    ``generator`` (seed 0 when None). ``u0`` warm-starts the iteration;
    ``return_vector=True`` also returns the final iterate for the next warm
    start. Each of the ``niter`` iterations takes two Hessian-vector
    products, and the norm one more.
    """
    assert x.ndim >= 2
    if x.is_cuda:
        require_fp32_matmul()
    dims = _feature_dims(x)
    if u0 is None:
        u0 = _normalize(_normal(x.shape, x, generator), dims)
    hvp = hvp_at(fun, x)
    u = v = u0
    for _ in range(niter):
        v = _normalize(hvp(u), dims)
        u = _normalize(hvp(v), dims)
    sigma = torch.sum(v * hvp(u), dim=dims)
    if return_vector:
        return sigma, u
    return sigma


def _check_lr(lr):
    auto = isinstance(lr, str) and lr == "auto"
    if not (auto or isinstance(lr, (int, float))):
        raise ValueError('expected `lr` to be either float or "auto".')
    return auto


def ista_nl(x, z0, decoder, alpha=1.0, fast=True, maxiter=10, lr="auto",
            power_iters=10, tol=1e-5, generator=None, lr_refresh=1,
            restart=False, axis_name=None, verbose=0, return_iters=False):
    """Nonlinear (F)ISTA on the device of ``x``.

    ``decoder``: a torch callable ``z -> x_hat`` with output shape matching
    ``x``. The arguments are those of the JAX package's ``ista_nl``:

    * ``lr='auto'``: a per-sample step 0.98 / L, L the Hessian 2-norm of the
      RSS at the point stepped from, by ``power_iters`` power iterations
      from one normalized normal draw of ``generator`` (a
      ``torch.Generator`` on x's device; seed 0 when None). The draw is
      made once and reused at every refresh, as the JAX package draws the
      same start from its key each time.
    * ``lr_refresh`` (auto-lr only): recompute the step every
      ``lr_refresh`` iterations, warm-starting the power iteration from
      the previous refresh's vector; 1 recomputes every iteration.
    * ``restart=True``: per-sample adaptive momentum restart (needs
      ``fast=True``).
    * The stop is batch-global: ``sum |z - z_next| <= z0.numel() * tol``.
    * ``verbose`` >= 1 prints the initial and final loss, > 1 also the loss
      of every iteration.
    * ``axis_name``: a ``torch.distributed.ProcessGroup`` whose ranks
      each hold rows of one batch; the stopping sum and threshold are
      all-reduced over it (``decoder`` must act row by row). The Hessian
      power iteration is row-local.

    Returns ``z``, and with ``return_iters=True`` also the number of
    iterations run (an int).
    """
    check_axis_name(axis_name)
    u0 = None
    if _check_lr(lr):
        u0 = _normalize(_normal(z0.shape, z0, generator), _feature_dims(z0))
    return _ista_nl(x, z0, decoder, alpha, fast, maxiter, lr, power_iters,
                    tol, u0, lr_refresh, restart, verbose, return_iters,
                    axis_name)


@torch.no_grad()
def _ista_nl(x, z0, decoder, alpha, fast, maxiter, lr, power_iters, tol, u0,
             lr_refresh, restart, verbose, return_iters, axis_name=None):
    """:func:`ista_nl` given ``u0``, the normalized start of the power
    iteration (used only with ``lr='auto'``)."""
    verbose = int(verbose)
    auto_lr = _check_lr(lr)
    if restart and not fast:
        raise ValueError("restart=True requires fast=True")
    lr_refresh = max(1, int(lr_refresh))
    x, z0 = x.detach(), z0.detach()
    if x.is_cuda:
        require_fp32_matmul()
    dtype = x.dtype
    # delta is compared with numel * tol rounded to x's dtype, as in JAX
    tol_total = global_tol(z0.numel(), tol, dtype, axis_name, x.device)
    dims = _feature_dims(z0)
    col = (z0.shape[0],) + (1,) * (z0.ndim - 1)

    def rss(zk):
        return 0.5 * torch.sum(torch.square(decoder(zk) - x))

    def lasso_loss(zk):
        return rss(zk) + alpha * torch.sum(torch.abs(zk))

    def step_size(at, u):
        L, u = hessian_2norm(rss, at, niter=power_iters, u0=u,
                             return_vector=True)
        return (0.98 / L).reshape(col), u

    def refresh(k, at, lr_c, u_c):
        if lr_refresh == 1:
            return step_size(at, u0)[0], u_c         # the reference cadence
        if k % lr_refresh == 0:
            return step_size(at, u_c)
        return lr_c, u_c

    def step(zk, lr_k):
        g = value_and_grad(rss, zk)[1]
        return soft_threshold(zk - lr_k * g, alpha * lr_k)

    lr_c = None if auto_lr else torch.tensor(lr, dtype=dtype)
    u_c = u0
    if verbose:
        print(f"initial loss: {float(lasso_loss(z0)):.4f}")
    z, y, z_prev, k, done = z0, z0, z0, 0, False
    if restart:
        t_vec = torch.zeros(col, dtype=dtype, device=z0.device)
    else:
        t = torch.tensor(1.0, dtype=dtype)
    while not done and k < maxiter:
        if restart:
            t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t_vec * t_vec)) * 0.5
            at = z + ((t_vec - 1.0) / t_next) * (z - z_prev)
        else:
            at = y if fast else z
        if auto_lr:
            lr_c, u_c = refresh(k, at, lr_c, u_c)
        z_next = step(at, lr_c)
        delta = torch.sum(torch.abs(z - z_next))
        done = float(psum(delta, axis_name)) <= tol_total    # host sync
        if restart:
            rdot = torch.sum((at - z_next) * (z_next - z), dim=dims,
                             keepdim=True)
            t_vec = torch.where(rdot > 0, 1.0, t_next)
            z_prev = z
        elif fast:
            t_next = (1 + torch.sqrt(1 + 4 * t * t)) / 2
            y = z_next + ((t - 1) / t_next) * (z_next - z)
            t = t_next
        if verbose > 1:
            print(f"iter {k + 1} - loss: {float(lasso_loss(z_next)):.4f}")
        z = z_next
        k += 1
    if verbose:
        print(f"final loss: {float(lasso_loss(z)):.4f}")
    if return_iters:
        return z, k
    return z
