"""Public encode API: code initialization and dispatch over solvers.

Counterpart of the JAX package's ``linear/sparse_encode.py``, with the same
algorithm names, init modes and per-algorithm init defaults; an unknown
name raises ``ValueError``.
"""

from __future__ import annotations

import warnings

import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linalg.basic import lstsq, ridge
from lasso_tpu_torch.ops.common import (matmul, per_feature_alpha_row,
                                        per_sample_alpha_column)

_init_defaults = {
    "ista": "zero",
    "cd": "zero",
    "cd-mod": "zero",
    "gpsr": "zero",
    "iter-ridge": "ridge",
    "interior-point": "ridge",
    "split-bregman": "zero",
    "own": "zero",
    "omp": "zero",   # unused: OMP takes no z0
    "group-ista": "zero",
}


def initialize_code(x, weight, alpha, mode, generator=None):
    """Initial codes z0 ([N, K], x's dtype and device): modes zero / unif /
    lstsq / ridge / transpose.

    ``'unif'`` draws U(-0.1, 0.1) from ``generator`` (a ``torch.Generator``
    on x's device; seed 0 when None). It cannot reproduce the JAX
    package's ``jax.random`` bits, only their distribution.
    """
    n_samples = x.shape[0]
    n_components = weight.shape[1]
    if mode == "zero":
        z0 = torch.zeros((n_samples, n_components), dtype=x.dtype,
                         device=x.device)
    elif mode == "unif":
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        z0 = torch.rand((n_samples, n_components), generator=generator,
                        dtype=x.dtype, device=x.device) * 0.2 - 0.1
    elif mode == "lstsq":
        z0 = lstsq(x.T, weight).T
    elif mode == "ridge":
        a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        if a.ndim >= 1:
            # per-sample alpha: the shared ridge factorization takes one
            # penalty, so use the mean
            a = torch.mean(a)
        z0 = ridge(x.T, weight, alpha=a).T
    elif mode == "transpose":
        z0 = matmul(x, weight, get_precision())
    else:
        raise ValueError(f"invalid init parameter {mode!r}.")
    return z0


def sparse_encode(x, weight, alpha=1.0, z0=None, algorithm="ista", init=None,
                  generator=None, return_iters=False, **kwargs):
    """Batched sparse coding: ``min_z 0.5||z W^T - x||^2 + alpha ||z||_1``.

    Algorithms: 'ista', 'cd', 'cd-mod', 'gpsr', 'iter-ridge',
    'interior-point', 'split-bregman', 'own' (orthant-wise Newton),
    'group-ista' and 'omp'; the remaining keyword arguments go to the
    solver. ``alpha`` may be a scalar, an ``[N]`` per-sample vector or a
    ``[1, K]`` per-feature row; ista and cd take all three natively,
    group-ista takes the first two and refuses the row, and the other
    algorithms get them through the homogeneity wrappers below (their
    tolerances then act in penalty-normalized units).
    ``generator`` seeds the ``'unif'`` init. ``return_iters=True``
    returns ``(z, n_iter)``. ``'omp'`` is the greedy L0 solver: it ignores
    ``alpha`` and ``z0`` and takes ``n_nonzero_coefs`` / ``tol``.
    """
    from lasso_tpu_torch.linear import solvers

    n_samples = x.shape[0]
    n_components = weight.shape[1]

    if algorithm == "omp":
        # its budget is n_nonzero_coefs / tol: the alpha wrappers and the
        # code initialization play no role
        return solvers.orthogonal_matching_pursuit(
            x, weight, return_iters=return_iters, **kwargs)

    a_row = per_feature_alpha_row(alpha, n_components, n_samples)
    if a_row is not None and algorithm == "group-ista":
        raise ValueError("per-feature [1, K] alpha is not supported for "
                         "group-ista; pass group_weights for per-group "
                         "penalties")
    if a_row is not None and algorithm not in ("ista", "cd"):
        # column rescaling for solvers without native per-feature alpha
        a_row = a_row.to(dtype=x.dtype, device=x.device)
        out = sparse_encode(
            x, weight / a_row, 1.0,
            z0=None if z0 is None else z0 * a_row, algorithm=algorithm,
            init=init, generator=generator, return_iters=return_iters,
            **kwargs)
        if return_iters:
            z_u, n_iter = out
            return z_u / a_row, n_iter
        return out / a_row

    a_col = (None if a_row is not None
             else per_sample_alpha_column(alpha, n_samples))
    if a_col is not None and algorithm not in ("ista", "cd", "group-ista"):
        # row rescaling for solvers without native per-sample alpha
        a_col = a_col.to(dtype=x.dtype, device=x.device)
        out = sparse_encode(
            x / a_col, weight, 1.0,
            z0=None if z0 is None else z0 / a_col, algorithm=algorithm,
            init=init, generator=generator, return_iters=return_iters,
            **kwargs)
        if return_iters:
            z_u, n_iter = out
            return z_u * a_col, n_iter
        return out * a_col

    if algorithm not in _init_defaults:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; expected one of "
            f"{sorted(_init_defaults)}")
    if z0 is not None:
        if tuple(z0.shape) != (n_samples, n_components):
            raise ValueError(f"z0 has shape {tuple(z0.shape)}, expected "
                             f"{(n_samples, n_components)}")
    else:
        if init is None:
            init = _init_defaults[algorithm]
        elif init == "zero" and algorithm == "iter-ridge":
            warnings.warn("zero init is a poor choice for iter-ridge: "
                          "coordinates at exactly zero freeze "
                          "permanently (use the ridge default)")
        z0 = initialize_code(x, weight, alpha, mode=init,
                             generator=generator)

    if algorithm == "cd-mod":
        # (z, gap[, n_iter]) inside, z or (z, n_iter) outward
        out = solvers.coord_descent_mod(x, weight, z0, alpha,
                                        return_iters=return_iters, **kwargs)
        return (out[0], out[2]) if return_iters else out[0]
    if algorithm == "cd":
        return solvers.coord_descent(x, weight, z0, alpha,
                                     return_iters=return_iters, **kwargs)
    if algorithm == "group-ista":
        # group lasso / sparse-group lasso: needs a ``groups`` kwarg (int
        # block size or [K] id array)
        return solvers.group_ista(x, z0, weight, alpha,
                                  return_iters=return_iters, **kwargs)
    if algorithm == "gpsr":
        prec = get_precision(kwargs.pop("precision", None))
        wt = weight.T
        return solvers.gpsr_basic(
            x, lambda v: matmul(v, wt, prec), tau=alpha,
            AT=lambda v: matmul(v, weight, prec), x0=z0,
            return_iters=return_iters, **kwargs)
    if algorithm == "iter-ridge":
        return solvers.iterative_ridge(z0, x, weight, alpha,
                                       return_iters=return_iters, **kwargs)
    if algorithm == "interior-point":
        # (z, success[, n_iter]) inside, z or (z, n_iter) outward
        out = solvers.interior_point(x, weight, z0, alpha,
                                     return_iters=return_iters, **kwargs)
        return (out[0], out[2]) if return_iters else out[0]
    if algorithm == "split-bregman":
        z, n_iter = solvers.split_bregman(weight, x, z0, alpha, **kwargs)
        return (z, n_iter) if return_iters else z
    if algorithm == "own":
        return solvers.orthant_wise_newton(weight, x, z0, alpha,
                                           return_iters=return_iters,
                                           **kwargs)
    return solvers.ista(x, z0, weight, alpha, return_iters=return_iters,
                        **kwargs)
