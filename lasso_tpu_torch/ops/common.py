"""Shared dense-op helpers used by every solver.

Counterpart of the JAX package's ``ops/common.py``.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lasso_tpu_torch.config import get_precision, require_fp32_matmul
from lasso_tpu_torch.ops.precision import round_bf16, split_bf16


# Iterations of the solvers' inner loops (conjugate gradients, backtracking
# line searches) by loop name, added up as they run: what a solve's n_iter
# does not show. Each such iteration reads its stopping test to the host.
INNER_ITERATIONS = collections.Counter()


def resolve_pallas(use_pallas, supported, device):
    """Kernel routing policy: resolve ``use_pallas`` ('auto' / True /
    False) against a shape-support predicate result.

    The name is kept from the JAX package so that both packages take the
    same keyword. Returns whether the fused step functions of
    :mod:`lasso_tpu_torch.ops.fused_ista` (or, for ``group_ista``, of
    :mod:`lasso_tpu_torch.ops.fused_group`) are used:

    * 'auto': only for tensors on a CUDA ``device`` with supported shapes
      (there the fused functions launch the hand-written kernels);
    * True: whenever the shapes are supported. On the CPU the fused
      functions then run their plain versions, which repeat the kernels'
      arithmetic (bf16 rounding included), as the JAX package runs its
      kernels in interpret mode off the TPU;
    * False: never; the solver takes its unfused plain step.
    """
    if use_pallas == "auto":
        return torch.device(device).type == "cuda" and supported
    return bool(use_pallas) and supported


def largest_aligned_divisor(n, limit, align=8):
    """Largest multiple of ``align`` that divides ``n`` and is <= limit.

    Requires ``align | n``; never returns less than ``align``.
    """
    assert n % align == 0, (n, align)
    m = n // align
    d = max(1, min(limit // align, m))
    while m % d != 0:
        d -= 1
    return align * d


def pad_lasso_operands(x, z0, weight, alpha=None):
    """Zero-pad ``(x, z0, weight[, per-feature alpha row])`` onto the
    fused path's grid (N % 8 == 0, D % 128 == 0, K % 128 == 0).

    Returns ``(x_p, z0_p, w_p, alpha_p, (N, K))`` (``alpha_p`` is None
    for a scalar alpha, ``z0_p`` is None when ``z0`` is), or ``None``
    when the shapes are already aligned. The padding is exact: zero
    feature rows leave ``W^T W`` and the residuals unchanged, zero atoms
    have a zero gradient and stay at 0 (their alpha entries are 1), and
    zero batch rows solve the zero problem at ``z = 0``. Callers rescale
    the global stopping threshold ``numel * tol`` to the original numel
    and slice the result back to ``[N, K]``.
    """
    N, D = x.shape
    K = weight.shape[1]
    Np = -(-N // 8) * 8
    Dp = -(-D // 128) * 128
    Kp = -(-K // 128) * 128
    if (Np, Dp, Kp) == (N, D, K):
        return None
    x_p = F.pad(x, (0, Dp - D, 0, Np - N))
    z0_p = None if z0 is None else F.pad(z0, (0, Kp - K, 0, Np - N))
    w_p = F.pad(weight, (0, Kp - K, 0, Dp - D))
    a_p = None
    if alpha is not None:
        a_arr = torch.as_tensor(alpha)
        if a_arr.ndim > 0:
            a_p = F.pad(a_arr.reshape(1, K), (0, Kp - K), value=1.0)
    return x_p, z0_p, w_p, a_p, (N, K)


def matmul(a, b, precision=None):
    """``a @ b`` at the given matmul precision (see
    :mod:`lasso_tpu_torch.config`)."""
    prec = get_precision(precision)
    if a.is_cuda:
        require_fp32_matmul()
    if prec == "default":
        return round_bf16(a) @ round_bf16(b)
    if prec == "high":
        a_hi, a_lo = split_bf16(a)
        b_hi, b_lo = split_bf16(b)
        return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    return a @ b


def l1_norm(x):
    return torch.sum(torch.abs(x))


def sq_norm(x):
    return torch.sum(torch.square(x))


def check_axis_name(axis_name):
    """Refuse an ``axis_name`` that is neither None nor a
    ``torch.distributed.ProcessGroup``.

    In the JAX package ``axis_name`` names the mesh axis a solver's
    batch-global sums ``psum`` over inside ``jax.shard_map``; here it is
    the process group whose ranks share the batch, one process per device
    (:mod:`lasso_tpu_torch.parallel` passes ``mesh.get_group('data')``).
    """
    if axis_name is not None and not isinstance(axis_name,
                                                dist.ProcessGroup):
        raise TypeError(
            f"axis_name must be None or a torch.distributed.ProcessGroup "
            f"(the group whose ranks share the batch, such as "
            f"mesh.get_group('data')), got {axis_name!r}")


def psum(value, axis_name):
    """Sum of ``value`` over the ranks of the process group ``axis_name``
    (``value`` itself when it is None), as ``lax.psum`` sums over a mesh
    axis. The sum is a new tensor on value's device; every rank must call
    it, in the same order."""
    if axis_name is None:
        return value
    out = value.detach().clone().contiguous()
    dist.all_reduce(out, group=axis_name)
    return out


def global_tol(numel, tol, dtype, axis_name, device):
    """The batch-global stopping threshold ``numel * tol`` as a float:
    rounded to ``dtype`` and, under ``axis_name``, the sum over the ranks
    of each rank's own rounded ``numel * tol`` (on ``device``), as the
    JAX package psums it."""
    total = torch.tensor(numel * tol, dtype=dtype)
    if axis_name is not None:
        total = psum(total.to(device), axis_name)
    return float(total)


def safe_div(num, den):
    """``num / den`` with 0 where ``den`` is 0, so that a converged or
    masked sample's 0/0 cannot poison the batch."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def row_dot(u, v):
    """Per-row inner products of [B, n] tensors, as a [B, 1] column."""
    return torch.sum(u * v, dim=1, keepdim=True)


def per_sample_alpha_column(alpha, batch_size, ndim=2):
    """Resolve a per-sample penalty vector to a broadcastable column.

    Returns ``None`` when ``alpha`` is a scalar, else an ``[N, 1, ...]``
    tensor (``ndim`` dims in all) validated against the batch size. The
    lasso is homogeneous in alpha, so with ``a_i > 0``

        argmin_z 0.5 ||z W^T - x_i||^2 + a_i ||z||_1
          = a_i * argmin_u 0.5 ||u W^T - x_i / a_i||^2 + 1 * ||u||_1

    and a per-sample-alpha solve is the alpha=1 solve on row-rescaled
    inputs.
    """
    arr = torch.as_tensor(alpha)
    if arr.ndim == 0:
        return None
    if tuple(arr.shape) not in ((batch_size,), (batch_size, 1)):
        raise ValueError(
            f"per-sample alpha must have shape ({batch_size},), got "
            f"{tuple(arr.shape)}")
    if not bool(torch.all(arr > 0)):
        raise ValueError("per-sample alpha entries must be > 0")
    return arr.reshape((batch_size,) + (1,) * (ndim - 1))


def per_feature_alpha_row(alpha, n_components, n_samples=None):
    """Resolve a per-feature (per-atom) penalty vector to a [1, K] row.

    Returns ``None`` when ``alpha`` is a scalar or a per-sample form,
    else a ``[1, K]`` tensor. Accepted per-feature shapes: ``(1, K)``
    always; bare ``(K,)`` only when ``K != n_samples`` (an ``(N,)``
    vector is per-sample).
    """
    arr = torch.as_tensor(alpha)
    if arr.ndim == 0:
        return None
    is_row = tuple(arr.shape) == (1, n_components) and n_components != 1
    is_bare = (tuple(arr.shape) == (n_components,)
               and (n_samples is None or n_components != n_samples))
    if not (is_row or is_bare):
        return None
    if not bool(torch.all(arr > 0)):
        raise ValueError("per-feature alpha entries must be > 0")
    return arr.reshape(1, n_components)


_GRAM_CHUNK_BYTES = 1 << 30


def weighted_gram(W, d, precision=None):
    """``W diag(d_b) W^T`` for each row ``d_b`` of ``d``: W [D, M], d
    [B, M] -> [B, D, D] (the JAX package's ``einsum('dk,bk,ek->bde')``).

    The batch goes through in chunks whose [b, D, M] scaled copy of W
    stays under 1 GiB, so that the temporary does not grow with the
    batch; each sample's products are the same in any chunking.
    """
    B = d.shape[0]
    Dn, M = W.shape
    out = torch.empty((B, Dn, Dn), dtype=W.dtype, device=W.device)
    step = max(1, _GRAM_CHUNK_BYTES // max(1, Dn * M * W.element_size()))
    Wt = W.T
    for s in range(0, B, step):
        out[s:s + step] = matmul(W[None] * d[s:s + step, None, :], Wt,
                                 precision)
    return out
