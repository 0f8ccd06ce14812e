"""Regularization paths: the whole alpha sweep as one batched solve.

Counterpart of the JAX package's ``linear/path.py``. Per-sample alpha
(lasso homogeneity, see ``ops.common.per_sample_alpha_column``) makes the
whole path one batched problem: the batch is tiled across the alpha axis
and the card solves the A*N independent rows in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def lasso_path(x, weight, alphas, algorithm="ista", mode="batched",
               **kwargs):
    """Solve ``min_z 0.5||z W^T - x||^2 + a||z||_1`` for every ``a`` in
    ``alphas``. Returns codes of shape ``[A, N, K]``.

    ``mode='batched'`` (default): one solve of an ``[A*N, D]`` problem
    with a per-sample alpha vector (most parallel; ``A*N*K`` codes in
    memory). ``mode='sequential'``: from the largest to the smallest
    alpha, each solve warm-started from the previous solution (constant
    memory, A solves).

    ``alphas`` must be positive. Extra kwargs go to
    :func:`lasso_tpu_torch.linear.sparse_encode` (``maxiter``,
    ``kernel_precision``, ...). Any dispatched algorithm with per-sample
    alpha works, ``'group-ista'`` included (the group norm is
    1-homogeneous; pass ``groups=...``).
    """
    from lasso_tpu_torch.linear.sparse_encode import sparse_encode

    alphas_arr = torch.as_tensor(alphas, dtype=x.dtype).reshape(-1)
    A = alphas_arr.shape[0]
    N = x.shape[0]
    K = weight.shape[1]

    if mode == "batched":
        x_tiled = torch.tile(x, (A, 1))                           # [A*N, D]
        a_vec = torch.repeat_interleave(alphas_arr.to(x.device), N)  # [A*N]
        z = sparse_encode(x_tiled, weight, alpha=a_vec,
                          algorithm=algorithm, **kwargs)
        return z.reshape(A, N, K)

    if mode == "sequential":
        # largest alpha first: its solution is the sparsest (cheapest),
        # and each later solve warm-starts from the previous one
        order = np.argsort(-alphas_arr.cpu().numpy())
        z_prev = None
        out = [None] * A
        for idx in order:
            z_prev = sparse_encode(x, weight, alpha=float(alphas_arr[idx]),
                                   z0=z_prev, algorithm=algorithm, **kwargs)
            out[int(idx)] = z_prev
        return torch.stack(out, dim=0)

    raise ValueError(f"mode must be 'batched' or 'sequential', got "
                     f"{mode!r}")
