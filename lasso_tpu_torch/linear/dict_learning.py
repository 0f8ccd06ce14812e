"""Alternating-minimization dictionary learning.

Counterpart of the JAX package's ``linear/dict_learning.py``, with the same
functions, arguments (``key`` becomes ``generator``, a ``torch.Generator``
on the data's device) and errors.

Python loops take the place of ``lax.scan`` and ``lax.fori_loop``. The
losses stay on the device and are stacked once at the end; the M-steps
read nothing back to the host (a degenerate atom is chosen with
``torch.where`` on a pre-drawn random atom), so the only host syncs of
an EM step are those of its E-step solver.

The random draws are taken in the public functions and handed to private
loop functions (:func:`_dict_learning`, :func:`_dict_learning_online`,
:func:`_update_dict`, :func:`_update_dict_block`) together with the
initial dictionary, so that the arithmetic can be held against the JAX
package on the JAX package's own draws. ``torch`` cannot reproduce
``jax.random`` bits, only their distributions.
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.basic import cholesky_solve
from lasso_tpu_torch.linear.sparse_encode import sparse_encode
from lasso_tpu_torch.ops.common import check_axis_name, matmul, psum


def _generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _randn(shape, generator, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def lasso_loss(X, Z, weight, alpha=1.0, precision=None):
    """Per-sample-mean lasso objective (a 0-d tensor on X's device)."""
    X_hat = matmul(Z, weight.T, get_precision(precision))
    loss = (0.5 * torch.sum(torch.square(X - X_hat))
            + alpha * torch.sum(torch.abs(Z)))
    return loss / X.shape[0]


def dict_evaluate(X, weight, alpha, **kwargs):
    """Encode X under the current dictionary and report the loss."""
    Z = sparse_encode(X, weight, alpha, **kwargs)
    return lasso_loss(X, Z, weight, alpha)


def update_dict(dictionary, X, Z, generator=None, positive=False, eps=1e-10,
                precision=None, axis_name=None):
    """Sequential per-atom dictionary update (sklearn-style).

    For each atom k in order: add back its rank-1 contribution to the
    residual, re-fit it as ``Z[:, k]^T R``, renormalize, and replace a
    degenerate atom (norm below ``eps``) by a random unit atom, zeroing
    its coefficients. One replacement atom per component is drawn up
    front from ``generator`` (``[K, D]``, as the JAX package draws them).
    Returns ``(dictionary, Z)`` as new tensors.

    ``axis_name``: a ``torch.distributed.ProcessGroup`` whose ranks each
    hold rows of X and Z. Each atom's refit ``Z[:, k]^T R`` is then
    all-reduced over it (K collectives of D values), the only quantity
    that spans rows; every rank then takes the same degenerate-atom
    branch. ``generator`` must be seeded alike on every rank.
    """
    check_axis_name(axis_name)
    generator = _generator(generator, dictionary.device)
    rand_atoms = _randn((dictionary.shape[1], dictionary.shape[0]),
                        generator, dictionary)
    return _update_dict(dictionary, X, Z, rand_atoms, positive, eps,
                        precision, axis_name)


def _update_dict(dictionary, X, Z, rand_atoms, positive=False, eps=1e-10,
                 precision=None, axis_name=None):
    """:func:`update_dict` on given replacement atoms ``[K, D]``."""
    prec = get_precision(precision)
    W, Z = dictionary.clone(), Z.clone()
    R = X - matmul(Z, W.T, prec)                                  # [N, D]
    for k in range(W.shape[1]):
        w_k, z_k = W[:, k], Z[:, k].clone()
        R = R + torch.outer(z_k, w_k)          # add back atom k
        atom = psum(matmul(z_k, R, prec), axis_name)   # re-fit it, [D]
        if positive:
            atom = torch.clamp_min(atom, 0.0)
        atom_norm = torch.linalg.vector_norm(atom)
        degenerate = atom_norm < eps
        rand_atom = rand_atoms[k]
        if positive:
            rand_atom = torch.clamp_min(rand_atom, 0.0)
        rand_atom = rand_atom / (torch.linalg.vector_norm(rand_atom) + 1e-30)
        atom_new = torch.where(
            degenerate, rand_atom,
            atom / torch.where(degenerate, 1.0, atom_norm))
        z_k_new = torch.where(degenerate, 0.0, z_k)
        W[:, k] = atom_new
        Z[:, k] = z_k_new
        # a degenerate atom's coefficients are now zero: nothing to remove
        R = R - torch.outer(z_k_new, atom_new)
    return W, Z


def update_dict_block(dictionary, X, Z, generator=None, positive=False,
                      eps=1e-10, lambd=1e-6, precision=None, axis_name=None):
    """Block-parallel constrained dictionary update: all atoms fit jointly
    by one ridge solve, columns renormalized to unit norm, degenerate
    atoms replaced by random unit atoms (``[D, K]`` drawn up front from
    ``generator``) with their coefficients zeroed. Returns
    ``(dictionary, Z)``. ``axis_name`` goes to the ridge fit's Gram sums
    (see :func:`update_dict_ridge`); ``generator`` must then be seeded
    alike on every rank."""
    check_axis_name(axis_name)
    generator = _generator(generator, dictionary.device)
    rand_atoms = _randn(tuple(dictionary.shape), generator, dictionary)
    return _update_dict_block(dictionary, X, Z, rand_atoms, positive, eps,
                              lambd, precision, axis_name)


def _update_dict_block(dictionary, X, Z, rand_atoms, positive=False,
                       eps=1e-10, lambd=1e-6, precision=None,
                       axis_name=None):
    """:func:`update_dict_block` on given replacement atoms ``[D, K]``."""
    V = update_dict_ridge(X, Z, lambd=lambd, precision=precision,
                          axis_name=axis_name)                     # [D, K]
    if positive:
        V = torch.clamp_min(V, 0.0)
    norms = torch.linalg.vector_norm(V, dim=0)                     # [K]
    degenerate = norms < eps
    if positive:
        rand_atoms = torch.clamp_min(rand_atoms, 0.0)
    rand_atoms = rand_atoms / (torch.linalg.vector_norm(
        rand_atoms, dim=0, keepdim=True) + 1e-30)
    W = torch.where(degenerate[None, :], rand_atoms,
                    V / torch.where(degenerate, 1.0, norms)[None, :])
    Z = torch.where(degenerate[None, :], 0.0, Z)
    return W, Z


def update_dict_ridge(x, z, lambd=1e-4, axis_name=None, precision=None):
    """Unconstrained ridge dictionary update: solve
    ``(Z^T Z + lambd N I) V^T = Z^T X`` and return ``V`` ``[D, K]``. A
    Gram matrix that is not positive definite yields NaNs, as in the JAX
    package. ``axis_name``: a ``torch.distributed.ProcessGroup`` whose
    ranks each hold rows of x and z; ``Z^T X``, ``Z^T Z`` and N are then
    all-reduced over it to their values over the whole batch."""
    check_axis_name(axis_name)
    prec = get_precision(precision)
    rhs = psum(matmul(z.T, x, prec), axis_name)                   # [K, D]
    M = psum(matmul(z.T, z, prec), axis_name)                     # [K, K]
    n = psum(torch.tensor(x.shape[0], dtype=x.dtype, device=x.device),
             axis_name)
    M = M + (lambd * n) * torch.eye(M.shape[0], dtype=M.dtype,
                                    device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.nan)
    return cholesky_solve(rhs, L).T


def _orthogonal_init(n_features, n_components, generator, like,
                     normalize):
    """An orthogonal ``[D, K]`` dictionary from ``generator``, with unit
    columns when ``normalize``."""
    weight = torch.empty((n_features, n_components), dtype=like.dtype,
                         device=like.device)
    torch.nn.init.orthogonal_(weight, generator=generator)
    if normalize:
        weight = weight / (torch.linalg.vector_norm(
            weight, dim=0, keepdim=True) + 1e-30)
    return weight


def dict_learning(X, n_components, alpha=1.0, constrained=True,
                  persist=False, lambd=1e-2, steps=60, generator=None,
                  algorithm="ista", dict_update="sequential",
                  block_lambd=1e-6, positive=False, progbar=False,
                  **solver_kwargs):
    """Alternating sparse-coding / dictionary-update EM loop.

    Returns ``(weight, losses)`` with ``losses: [steps]``, each taken
    after the E-step and before the M-step. ``generator`` (default: seed 0
    on X's device) draws the orthogonal initial dictionary, then the
    replacement atoms of every step. ``dict_update`` picks the
    constrained M-step: ``'sequential'`` (per atom, order-dependent) or
    ``'block'`` (one joint ridge fit, ``block_lambd``); ``constrained=
    False`` takes the ridge M-step (``lambd``, scaled by N).
    ``positive=True`` (constrained only) projects the atoms onto the
    nonnegative orthant. ``persist`` warm-starts each E-step from the
    previous M-step's codes. ``progbar`` prints each step's loss (a host
    sync per step). ``solver_kwargs`` go to :func:`sparse_encode`.
    """
    if dict_update not in ("sequential", "block"):
        raise ValueError(f"dict_update must be 'sequential' or 'block', "
                         f"got {dict_update!r}")
    if positive and not constrained:
        raise ValueError("positive=True requires constrained=True (the "
                         "ridge M-step has no nonnegativity projection)")
    generator = _generator(generator, X.device)
    weight, step_atoms = _em_draws(X, n_components, steps, generator,
                                   constrained, dict_update)
    return _dict_learning(X, weight, step_atoms, alpha, constrained,
                          persist, lambd, steps, algorithm, dict_update,
                          block_lambd, positive, progbar, **solver_kwargs)


def _em_draws(X, n_components, steps, generator, constrained, dict_update):
    """The random draws of :func:`dict_learning`, in its order: the
    initial dictionary ``[D, K]``, then (constrained only, else None) the
    replacement atoms of every step, ``[steps, K, D]`` for the sequential
    M-step or ``[steps, D, K]`` for the block one."""
    weight = _orthogonal_init(X.shape[1], n_components, generator, X,
                              constrained)
    step_atoms = None
    if constrained:
        shape = ((n_components, X.shape[1]) if dict_update == "sequential"
                 else (X.shape[1], n_components))
        step_atoms = _randn((steps,) + shape, generator, X)
    return weight, step_atoms


def _dict_learning(X, weight, step_atoms, alpha=1.0, constrained=True,
                   persist=False, lambd=1e-2, steps=60, algorithm="ista",
                   dict_update="sequential", block_lambd=1e-6,
                   positive=False, progbar=False, start=0, Z0=None,
                   return_codes=False, **solver_kwargs):
    """The EM loop of :func:`dict_learning` from the initial dictionary
    ``weight`` ``[D, K]`` and the replacement atoms of each step
    (``step_atoms[s]``: ``[K, D]`` for the sequential M-step, ``[D, K]``
    for the block one; unused when unconstrained).

    It runs steps ``start`` to ``steps - 1``, warm-started (with
    ``persist``) from ``Z0``, the codes the step before ``start`` left
    (None before step 0). With ``return_codes`` it returns ``(weight, Z,
    losses)``, ``Z`` the codes the last step left, so that a run can go on
    in segments (:func:`lasso_tpu_torch.utils.dict_learning_resumable`).
    """
    losses = []
    for s in range(start, steps):
        Z = sparse_encode(X, weight, alpha, z0=Z0 if persist else None,
                          algorithm=algorithm, **solver_kwargs)
        loss = lasso_loss(X, Z, weight, alpha)
        losses.append(loss)
        if progbar:
            print(f"dict_learning loss: {float(loss)}")
        if constrained and dict_update == "sequential":
            weight, Z = _update_dict(weight, X, Z, step_atoms[s], positive)
        elif constrained:
            weight, Z = _update_dict_block(weight, X, Z, step_atoms[s],
                                           positive, lambd=block_lambd)
        else:
            weight = update_dict_ridge(X, Z, lambd=lambd)
        Z0 = Z
    losses = torch.stack(losses) if losses else X.new_zeros((0,))
    return (weight, Z0, losses) if return_codes else (weight, losses)


def update_dict_online(dictionary, A, B, sweeps=1, positive=False,
                       eps=1e-10, axis_name=None):
    """Online dictionary update from sufficient statistics (Mairal, Bach,
    Ponce & Sapiro 2009, Algorithm 2): ``sweeps`` passes of block
    coordinate descent over the atoms,

        u_k = w_k + (B[:, k] - W A[:, k]) / A[k, k]
        w_k = u_k / max(||u_k||_2, 1)        (unit-ball projection)

    with ``A = sum z z^T`` ``[K, K]`` and ``B = sum x^T z`` ``[D, K]``.
    Atoms with ``A[k, k] < eps`` (never activated) are left unchanged.
    ``axis_name`` is accepted for the JAX package's signature and unused
    (the statistics are already global).
    """
    del axis_name
    prec = get_precision(None)
    W = dictionary.clone()
    for _ in range(sweeps):
        for k in range(W.shape[1]):
            a_kk = A[k, k]
            u = W[:, k] + (B[:, k] - matmul(W, A[:, k], prec)) \
                / torch.clamp_min(a_kk, eps)
            if positive:
                u = torch.clamp_min(u, 0.0)
            w_new = u / torch.clamp_min(torch.linalg.vector_norm(u), 1.0)
            W[:, k] = torch.where(a_kk < eps, W[:, k], w_new)
    return W


def dict_learning_online(X, n_components, alpha=1.0, batch_size=256,
                         steps=500, generator=None, algorithm="ista",
                         forget=None, positive=False, eps=1e-10,
                         dict_sweeps=1, stats_jitter=1e-6, progbar=False,
                         **solver_kwargs):
    """Online (minibatch) dictionary learning, Mairal et al. 2009.

    Each step draws a ``batch_size`` minibatch (uniformly with
    replacement; all indices drawn up front from ``generator``),
    sparse-codes it under the current dictionary, folds it into the
    statistics ``A <- gamma A + Z^T Z / batch_size`` and ``B <- gamma B +
    X^T Z / batch_size`` (``gamma = forget`` in (0, 1], None for 1), and
    runs ``dict_sweeps`` atom sweeps (:func:`update_dict_online`). ``A``
    starts at ``stats_jitter * I`` and ``B`` at ``stats_jitter * W0``.
    Returns ``(weight, losses)``, ``losses[t]`` the minibatch loss of
    step t.
    """
    n_samples = X.shape[0]
    if not 0 < batch_size:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    batch_size = min(batch_size, n_samples)
    if forget is not None and not 0.0 < forget <= 1.0:
        raise ValueError(f"forget must be in (0, 1], got {forget}")
    gamma = 1.0 if forget is None else float(forget)
    generator = _generator(generator, X.device)
    weight = _orthogonal_init(X.shape[1], n_components, generator, X, True)
    idx = torch.randint(0, n_samples, (steps, batch_size),
                        generator=generator, device=X.device)
    A0 = stats_jitter * torch.eye(n_components, dtype=X.dtype,
                                  device=X.device)
    B0 = stats_jitter * weight
    return _dict_learning_online(X, weight, idx, A0, B0, alpha, gamma,
                                 positive, eps, dict_sweeps, progbar,
                                 algorithm, **solver_kwargs)


def _dict_learning_online(X, weight, idx, A, B, alpha=1.0, gamma=1.0,
                          positive=False, eps=1e-10, dict_sweeps=1,
                          progbar=False, algorithm="ista", **solver_kwargs):
    """The loop of :func:`dict_learning_online` from the initial
    dictionary, the minibatch indices ``idx`` ``[steps, batch]`` and the
    initial statistics ``A`` ``[K, K]`` and ``B`` ``[D, K]``."""
    prec = get_precision(None)
    losses = []
    for idx_t in idx:
        x_t = X[idx_t]                                            # [B, D]
        batch = x_t.shape[0]
        Z = sparse_encode(x_t, weight, alpha, algorithm=algorithm,
                          **solver_kwargs)
        loss = lasso_loss(x_t, Z, weight, alpha)
        losses.append(loss)
        if progbar:
            print(f"dict_learning_online loss: {float(loss)}")
        A = gamma * A + matmul(Z.T, Z, prec) / batch
        B = gamma * B + matmul(x_t.T, Z, prec) / batch
        weight = update_dict_online(weight, A, B, sweeps=dict_sweeps,
                                    positive=positive, eps=eps)
    return weight, torch.stack(losses) if losses else X.new_zeros((0,))
