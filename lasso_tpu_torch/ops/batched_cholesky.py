"""Batched Cholesky solves: the hand-written CUDA kernels and their plain
versions.

Counterpart of the JAX package's ``ops/batched_cholesky.py``, whose two
TPU kernels become K7 and K8 of ``csrc/chol.cu``.

**The append (K7).** Greedy solvers that grow a PD system one row and
column a step (OMP's support normal equations) carry the inverse factor
``V = L^{-1}`` of each sample and append the new row in O(T^2), with no
substitution chain:

    y    = V g[:k]                       (L y = g forward solve)
    u    = y^T V
    lkk  = sqrt(max(g_k - y.y, 1e-6 g_k + 1e-30))
    V[k] = [-u / lkk, 1 / lkk, 0 ...]    (block inverse of [[L, 0], [y', lkk]])
    z    = V^T (V b)                     ((L L^T)^{-1} b)

The relative pivot floor turns a linearly dependent append (a duplicated
atom) into a bounded perturbation of the dependent direction instead of a
NaN, and leaves healthy pivots unchanged. Rows of V past the appended block
stay identity rows, so zero-padded right-hand-side slots solve to exactly
zero. The layout is the JAX package's, batch innermost: V ``[T, T, B]``
(``V[i]`` is row i as ``[T, B]``), g, b and z ``[T, B]``. Up to T = 64 the
kernel reads each element of the live triangle once (the row sums and
the column sums from one load, a panel of rows at a time); above, the first
kernel sweeps it four times (:func:`append_tier`).

**The full solve (K8).** :func:`batch_cholesky_solve_lanes` solves a batch
of PD systems ``A_s x_s = b_s`` (b ``[B, D]``, A ``[B, D, D]``, D <= 256)
by the column recurrence with ``rsqrt`` of each pivot, then forward and
back substitution, in PyTorch's own ``[B, D, D]`` layout (the TPU kernel's
``[D, D, B]`` transpose and its padding of B exist only for the TPU's
lanes). Up to D = 64 a sample belongs to part of one warp, which holds its
factor in registers; above, to a block of 128 or 256 threads with the
factor as 32 x 32 tiles in shared memory. It has no pivot floor: a non-PD
system gives a non-finite x, which sends the caller's batch to an LU solve
(:func:`lasso_tpu_torch.linalg.batch_cholesky_solve`).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version; a tensor on any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from lasso_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

# the C entries of csrc/chol.cu
CHOL_APPEND_SOLVE = _cuda.CudaKernel("chol", "chol_append_solve",
                                     [_P] * 4 + [_I] * 3 + [_P])
CHOL_SOLVE = _cuda.CudaKernel("chol", "chol_solve", [_P] * 3 + [_I] * 2 + [_P])
# K7's sweep kernel (T past 64) keeps y (then t) and the new row of a
# block's 32 samples in shared memory: (2 T + 8) x 32 floats within the
# 227 KB of one H100 block
_MAX_T = (227 * 1024 // (32 * 4) - 8) // 2
_PANEL_T = 64   # up to here K7's panel kernel reads the triangle once


def append_tier(T, B):
    """The K7 kernel that takes an append of width T: 'panel' up to T = 64
    (each element of the live triangle read once, a panel of rows in
    registers), 'sweep' above (the first kernel, four sweeps over
    the triangle). Both take any B >= 1."""
    return "panel" if T <= _PANEL_T else "sweep"


def supports_lanes_append(T, B, dtype):
    """Shapes the append kernel takes: float32, T a multiple of 8 (the
    JAX package's panel alignment, which fixes the padded width Tp of the
    solver's carried factor) and T within K7's shared memory. The TPU's
    VMEM term has no counterpart."""
    return dtype == torch.float32 and T % 8 == 0 and B >= 1 and T <= _MAX_T


def cholesky_append_solve_lanes(L, g_row, b, k, out=None):
    """Append row ``k`` to each carried inverse factor and solve.

    L: [T, T, B], the carried inverse Cholesky factor ``V = L^{-1}``
    (``V[i]`` is row i as [T, B]; initialize it to the identity and grow it
    by appends, which keep it lower triangular with identity rows past the
    block); g_row: [T, B], the new symmetric row of the Gram (entries past
    k are ignored, ``g_row[k]`` is the new diagonal); b: [T, B]; k: int.
    Returns ``(V_new, z)`` with z [T, B]. The kernel writes row k of the
    factor in place: ``out=L`` updates L itself; another ``out`` receives
    a copy of L first, and with no ``out`` ``V_new`` is a new copy.
    """
    T, _, B = L.shape
    k = int(k)
    if not 0 <= k < T:
        raise ValueError(f"k={k} is outside [0, {T})")
    if L.device.type == "cpu":
        V, z = cholesky_append_solve_lanes_plain(L, g_row, b, k)
        if out is None:
            return V, z
        out.copy_(V)
        return out, z
    _cuda.check_cuda(L=L, g_row=g_row, b=b, out=out)
    _cuda.check_shapes({"g_row": (g_row, (T, B)), "b": (b, (T, B)),
                        "out": (out, (T, T, B))})
    if not supports_lanes_append(T, B, L.dtype):
        raise ValueError(f"the append kernel needs float32, T % 8 == 0 and "
                         f"T <= {_MAX_T}, got T={T}, {L.dtype}")
    if out is None:
        V = L.clone()
    else:
        V = out
        if out.data_ptr() != L.data_ptr():
            out.copy_(L)
    z = torch.empty_like(b)
    CHOL_APPEND_SOLVE(V.data_ptr(), g_row.data_ptr(), b.data_ptr(),
                      z.data_ptr(), k, T, B, _cuda.stream())
    return V, z


def cholesky_append_solve_lanes_plain(L, g_row, b, k):
    """The plain version of :func:`cholesky_append_solve_lanes`, on any
    device: the TPU kernel's dense contractions over the whole [T, T, B]
    factor (the kernel reads only the live block; the rest adds exact
    zeros), with the same pivot floor. Returns a new ``(V_new, z)``."""
    T, _, B = L.shape
    cols = torch.arange(T, device=L.device).reshape(1, T, 1)
    g3 = g_row.reshape(1, T, B)
    y3 = torch.sum(L * torch.where(cols < k, g3, 0.0), dim=1,
                   keepdim=True)                               # V g [T,1,B]
    u3 = torch.sum(L * y3, dim=0, keepdim=True)                # y'V [1,T,B]
    gkk = g_row[k]                                             # [B]
    yy = torch.sum(y3 * y3, dim=0).reshape(B)
    pivot = torch.maximum(gkk - yy, 1e-6 * gkk + 1e-30)
    inv_lkk = torch.rsqrt(pivot)
    new_row = (torch.where(cols < k, -u3, 0.0)
               + torch.where(cols == k, 1.0, 0.0)) * inv_lkk
    V = L.clone()
    V[k] = new_row.reshape(T, B)
    t3 = torch.sum(V * b.reshape(1, T, B), dim=1, keepdim=True)   # V b
    z = torch.sum(V * t3, dim=0)                                  # V'(V b)
    return V, z


# K8 solves D <= 64 with a warp's registers (the factor's rows) and above
# keeps a sample's lower triangle as 32 x 32 tiles in shared memory, 151.8
# KB at D = 256
_MAX_D = 256


def supports_lanes_cholesky(b, A):
    """Shapes the full solve kernel takes: float32, D <= 256 and any batch
    B >= 1 (the JAX package's gate without its VMEM term). Larger D takes
    the library route of the caller, in both packages."""
    B, D = b.shape
    return A.dtype == torch.float32 and D <= _MAX_D and B >= 1


def batch_cholesky_solve_lanes(b, A):
    """Solve the PD systems ``A_s x_s = b_s``: b ``[B, D]``, A ``[B, D, D]``
    (symmetric; its upper triangle is read) -> x ``[B, D]``. A system that
    is not PD gives a non-finite x (there is no pivot floor)."""
    B, D = b.shape
    if A.device.type == "cpu":
        return batch_cholesky_solve_lanes_plain(b, A)
    _cuda.check_cuda(b=b, A=A)
    _cuda.check_shapes({"A": (A, (B, D, D))})
    if not supports_lanes_cholesky(b, A):
        raise ValueError(f"the Cholesky solve kernel needs float32, B >= 1 "
                         f"and D <= {_MAX_D}, got B={B}, D={D}, {A.dtype}")
    x = torch.empty_like(b)
    CHOL_SOLVE(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, D,
               _cuda.stream())
    return x


def batch_cholesky_solve_lanes_plain(b, A):
    """The plain version of :func:`batch_cholesky_solve_lanes`, on any
    device: the kernel's column recurrence (``rsqrt`` of each pivot, the
    scaled column, the trailing update) and its column-oriented forward and
    back substitutions, batched over B with elementwise torch ops. Like the
    kernel it reads A's upper triangle and has no pivot floor. The kernel
    fuses each update's multiply and subtract; here they round apart."""
    B, D = b.shape
    S = torch.triu(A) + torch.triu(A, 1).transpose(1, 2)  # symmetric copy
    L = torch.zeros_like(A)
    for j in range(D):
        inv = torch.rsqrt(S[:, j, j])
        c = S[:, j:, j] * inv[:, None]                    # L[j:, j]
        L[:, j:, j] = c
        S[:, j + 1:, j + 1:] -= c[:, 1:, None] * c[:, None, 1:]
    r, y = b.clone(), torch.empty_like(b)
    for j in range(D):                                    # L y = b
        y[:, j] = r[:, j] / L[:, j, j]
        r[:, j + 1:] -= y[:, j, None] * L[:, j + 1:, j]
    x = torch.empty_like(b)
    for j in range(D - 1, -1, -1):                        # L^T x = y
        x[:, j] = y[:, j] / L[:, j, j]
        y[:, :j] -= x[:, j, None] * L[:, j, :j]
    return x
