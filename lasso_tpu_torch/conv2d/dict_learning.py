"""Convolutional dictionary learning.

Counterpart of the JAX package's ``conv2d/dict_learning.py``, with the same
functions and arguments (``key`` becomes ``generator``, a
``torch.Generator`` on the data's device).

The M-step ``min_W 0.5 ||conv_transpose2d(Z, W) - X||^2`` is linear least
squares in the filter stack, solved matrix-free by conjugate gradients on
the normal equations in filter space: the decode map ``V ->
conv_transpose2d(Z, V)`` and its adjoint (the weight gradient of that
convolution, one library convolution over the batch) give the normal
operator ``A(V) = adj(dec(V)) + lambd V`` on the ``[C_z, C_x, kh, kw]``
filters, warm-started from the current filters.

A Python loop takes the place of the JAX package's ``lax.scan``: the
losses stay on the device, and the only host reads of an EM step are those
of its E-step (:func:`ista_conv2d`) and of the M-step's CG loop (one an
iteration). The random draws are taken in the public functions and handed
to the private ones (:func:`_update_kernel_constrained`,
:func:`_conv_dict_learning`), so that the arithmetic can be held against
the JAX package on the JAX package's own draws.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.conv2d.ista import ista_conv2d
from lasso_tpu_torch.conv2d.ops import (_code_shape, _conv2d_weight,
                                        conv_transpose2d)
from lasso_tpu_torch.linalg.conjgrad import conjgrad
from lasso_tpu_torch.linear.dict_learning import _generator, _randn
from lasso_tpu_torch.ops.common import check_axis_name, psum


def conv_lasso_loss(X, Z, weight, alpha=1.0, stride=1, padding=0):
    """Per-sample-mean conv lasso objective (the conv analogue of
    :func:`lasso_tpu_torch.linear.lasso_loss`)."""
    X_hat = conv_transpose2d(Z, weight, stride=stride, padding=padding)
    loss = (0.5 * torch.sum(torch.square(X - X_hat))
            + torch.sum(alpha * torch.abs(Z)))
    return loss / X.shape[0]


def _unit_filters(V):
    return V / (torch.sqrt(torch.sum(torch.square(V), dim=(1, 2, 3),
                                     keepdim=True)) + 1e-30)


def update_kernel(X, Z, weight, stride=1, padding=0, lambd=0.0,
                  cg_iters=30, cg_tol=1e-9, axis_name=None):
    """Least-squares filter refit ``min_V 0.5||conv_t(Z, V) - X||^2 +
    0.5 lambd ||V||^2``, warm-started from ``weight``: CG on the normal
    equations in filter space for the correction from ``weight``, with no
    relative exit (the EM loop needs a descent step, and CG's default
    relative exit stops near 5% of the residual).

    ``axis_name``: a ``torch.distributed.ProcessGroup`` whose ranks each
    hold images of X and Z; the adjoint's outputs (filter-sized) are then
    all-reduced over it, one collective a CG iteration, and the CG state
    stays the same on every rank."""
    check_axis_name(axis_name)

    def dec(V):
        return conv_transpose2d(Z, V, stride=stride, padding=padding)

    def adj(R):
        return psum(_conv2d_weight(R, Z, weight.shape, stride, padding),
                    axis_name)

    def Adot(V):
        AV = adj(dec(V))
        if lambd:
            AV = AV + lambd * V
        return AV

    r0 = adj(X) - Adot(weight)
    d = conjgrad(r0, Adot, lambda u, v: torch.sum(u * v), maxiter=cg_iters,
                 tol=cg_tol, rtol=0.0)
    return weight + d


def update_kernel_constrained(X, Z, weight, generator=None, stride=1,
                              padding=0, lambd=1e-6, cg_iters=30, eps=1e-10,
                              axis_name=None):
    """Constrained filter update: the CG refit of :func:`update_kernel`,
    each filter projected onto the unit sphere, and each degenerate filter
    (norm below ``eps``) replaced by a random unit filter drawn from
    ``generator`` (default: seed 0 on the filters' device), its code
    channel zeroed. Returns ``(weight, Z)``. ``axis_name`` goes to
    :func:`update_kernel`; ``generator`` must then be seeded alike on
    every rank."""
    check_axis_name(axis_name)
    generator = _generator(generator, weight.device)
    rand = _randn(tuple(weight.shape), generator, weight)
    return _update_kernel_constrained(X, Z, weight, rand, stride, padding,
                                      lambd, cg_iters, eps, axis_name)


def _update_kernel_constrained(X, Z, weight, rand, stride=1, padding=0,
                               lambd=1e-6, cg_iters=30, eps=1e-10,
                               axis_name=None):
    """:func:`update_kernel_constrained` on a given draw ``rand`` of the
    filters' shape."""
    V = update_kernel(X, Z, weight, stride=stride, padding=padding,
                      lambd=lambd, cg_iters=cg_iters, axis_name=axis_name)
    norms = torch.sqrt(torch.sum(torch.square(V), dim=(1, 2, 3)))  # [C_z]
    degenerate = norms < eps
    scale = torch.where(degenerate, 1.0, norms)[:, None, None, None]
    W_new = torch.where(degenerate[:, None, None, None], _unit_filters(rand),
                        V / scale)
    Z_new = torch.where(degenerate[None, :, None, None], 0.0, Z)
    return W_new, Z_new


def conv_dict_learning(X, n_filters, kernel_size, alpha=0.1, steps=30,
                       stride=1, padding=0, constrained=True, lambd=None,
                       persist=False, generator=None, cg_iters=30, eps=1e-10,
                       progbar=False, **solver_kwargs):
    """Alternating conv sparse-coding / filter-update EM loop.

    X: ``[N, C_x, H, W]``; learns ``weight: [n_filters, C_x, kh, kw]``
    (the ``conv_transpose2d`` layout, code channels first). Returns
    ``(weight, losses)`` with ``losses: [steps]`` on X's device, each taken
    after the E-step and before the M-step.

    ``generator`` (default: seed 0 on X's device) draws the initial
    filters, normalized, then the replacement filters of every step
    (constrained only). ``constrained=True`` keeps the filters unit-norm
    and re-draws degenerate ones (``lambd`` then defaults to a 1e-6
    stabilizer); ``constrained=False`` runs the plain ridge refit
    (``lambd`` defaults to 1e-4). ``persist=True`` warm-starts each E-step
    from the previous step's codes. ``progbar`` prints each step's loss (a
    host read a step). ``solver_kwargs`` go to :func:`ista_conv2d`
    (``maxiter`` defaults to 100).
    """
    generator = _generator(generator, X.device)
    kh, kw = (kernel_size if isinstance(kernel_size, (tuple, list))
              else (kernel_size, kernel_size))
    shape = (n_filters, X.shape[1], kh, kw)
    weight = _unit_filters(_randn(shape, generator, X))
    step_rand = (_randn((steps,) + shape, generator, X) if constrained
                 else None)
    return _conv_dict_learning(
        X, weight, step_rand, alpha=alpha, steps=steps, stride=stride,
        padding=padding, constrained=constrained, lambd=lambd,
        persist=persist, cg_iters=cg_iters, eps=eps, progbar=progbar,
        **solver_kwargs)


def _conv_dict_learning(X, weight, step_rand, alpha=0.1, steps=30, stride=1,
                        padding=0, constrained=True, lambd=None,
                        persist=False, cg_iters=30, eps=1e-10, progbar=False,
                        **solver_kwargs):
    """The EM loop of :func:`conv_dict_learning` from the initial filters
    ``weight`` and the replacement draws of each step (``step_rand[s]``,
    of the filters' shape; unused when unconstrained)."""
    if lambd is None:
        lambd = 1e-6 if constrained else 1e-4
    solver_kwargs.setdefault("maxiter", 100)
    Z0_init = X.new_zeros(_code_shape(X.shape, weight.shape, stride,
                                      padding))
    Z = Z0_init
    losses = []
    for s in range(steps):
        Z = ista_conv2d(X, Z if persist else Z0_init, weight, alpha,
                        stride=stride, padding=padding, **solver_kwargs)
        loss = conv_lasso_loss(X, Z, weight, alpha, stride=stride,
                               padding=padding)
        losses.append(loss)
        if progbar:
            print(f"conv_dict_learning loss: {float(loss)}")
        if constrained:
            weight, Z = _update_kernel_constrained(
                X, Z, weight, step_rand[s], stride=stride, padding=padding,
                lambd=lambd, cg_iters=cg_iters, eps=eps)
        else:
            weight = update_kernel(X, Z, weight, stride=stride,
                                   padding=padding, lambd=lambd,
                                   cg_iters=cg_iters)
    return weight, torch.stack(losses) if losses else X.new_zeros((0,))
