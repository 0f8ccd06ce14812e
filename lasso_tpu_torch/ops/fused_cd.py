"""Fused coordinate-descent steps: hand-written CUDA kernels and their plain
versions.

Counterpart of the JAX package's ``ops/fused_cd.py``. Two kernels of
``csrc/cd.cu``:

* :func:`fused_cd_steps` (K3): ``steps`` greedy CD steps per launch. Per
  row: take the first coordinate k of the largest
  ``|prox(b, alpha) * scale - z|``, then ``b += act * dz * S[k, :]``
  (``S = I - W^T W``), ``z_k += act * dz``, and freeze the row once
  ``|dz| <= tol_k``. A frozen row is left as it is, so extra steps change
  no stopping decision.
* :func:`fused_cd_mod_sweep` (K4): one cyclic sweep over all K atoms of the
  sklearn-style CD, with per-row ``zmax`` and ``dzmax``, blocked over
  chunks of :data:`SWEEP_TJ` atoms (two products a chunk and a per-row
  triangular recurrence through the chunk's Gram block).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
PyTorch version (:func:`fused_cd_steps_plain`,
:func:`fused_cd_mod_sweep_plain`), which repeats the kernel's arithmetic;
a tensor on any other device raises.

``kernel_precision`` of the greedy steps: ``'f32'`` gathers rows of the
true f32 S (the TPU kernel gathers a bf16 hi + lo split, because its
gather is a matrix-unit product; a plain load needs no split), ``'bf16'``
rows of ``S`` rounded to bf16.
"""

from __future__ import annotations

import ctypes

import torch

from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the C entries of csrc/cd.cu
CD_STEPS = {kp: _cuda.CudaKernel("cd", f"cd_steps_{kp}",
                                 [_P] * 5 + [_F] * 3 + [_I] + [_P] * 3
                                 + [_I] * 3 + [_P])
            for kp in ("f32", "bf16")}
CD_MOD_SWEEP = _cuda.CudaKernel("cd", "cd_mod_sweep",
                                [_P] * 5 + [_F] * 2 + [_P] * 5 + [_I] * 3
                                + [_P])
SWEEP_TJ = 16                    # atoms a chunk of K4 (SW_TJ in csrc/cd.cu)
_SMEM_FLOATS = 227 * 1024 // 4   # shared memory of one H100 block


def supports_fused_cd(b, weight):
    """Shapes the fused greedy path takes: K a multiple of 128 and N of 8
    in float32, as in the JAX package. The kernel needs neither; the grid
    is kept because it decides the padding, and with it the stopping
    threshold and ``n_iter``. The TPU's VMEM budget has no counterpart."""
    K = weight.shape[1]
    N = b.shape[0]
    return K % 128 == 0 and N % 8 == 0 and b.dtype == torch.float32


def supports_fused_cd_mod(z, weight):
    """The cyclic sweep kernel takes every float32 shape. The JAX package's
    other conditions are the TPU's own: K <= 1792 (its compiler fails at
    K = 2048), N a multiple of 128 (lanes) and a VMEM budget."""
    return z.dtype == torch.float32


def _f32(v, device=None):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _scale(l2):
    """``1 / (1 + l2)`` in float32: the elastic-net coordinate
    contraction."""
    return 1.0 / (1.0 + _f32(l2))


def fused_cd_steps(b, z, active, S, alpha, tol_k, steps=8,
                   kernel_precision="f32", nonneg=False, l2=0.0):
    """``steps`` fused greedy-CD iterations. Returns ``(b, z, active)``.

    b, z: [N, K]; active: [N, 1] float 0/1 mask; S: [K, K] = I - W^T W.
    ``alpha`` (shrink threshold) is a scalar or a per-feature ``[1, K]``
    row; ``tol_k`` is the per-row deactivation threshold (tol * K);
    ``l2 > 0`` scales the shrink by ``1 / (1 + l2)``. The inputs are not
    written. The TPU arguments ``block_n`` and ``interpret`` have no
    counterpart: the device of ``b`` picks the kernel or the plain
    version.
    """
    check_kernel_precision(kernel_precision)
    if b.device.type == "cpu":
        return fused_cd_steps_plain(b, z, active, S, alpha, tol_k, steps,
                                    kernel_precision, nonneg, l2)
    N, K = b.shape
    a = _f32(alpha)
    trow = None
    if a.ndim > 0:
        trow = a.to(b.device).reshape(1, K).contiguous()
    _cuda.check_cuda(b=b, z=z, active=active, S=S, trow=trow)
    _cuda.check_shapes({"z": (z, (N, K)), "active": (active, (N, 1)),
                   "S": (S, (K, K)), "trow": (trow, (1, K))})
    if K < 32 or N == 0:
        raise ValueError(f"the cd_steps kernel needs K >= 32 and N > 0, got "
                         f"N={N}, K={K}")
    if 2 * K > _SMEM_FLOATS:
        raise ValueError(f"K={K}: one row of b and z exceeds a block's "
                         f"shared memory")
    s_arg = S if kernel_precision == "f32" else S.to(torch.bfloat16)
    b_out, z_out = torch.empty_like(b), torch.empty_like(z)
    act_out = torch.empty_like(active)
    CD_STEPS[kernel_precision](
        b.data_ptr(), z.data_ptr(), active.data_ptr(), s_arg.data_ptr(),
        _cuda.ptr(trow), 0.0 if trow is not None else float(a),
        float(_f32(tol_k)), float(_scale(l2)), int(nonneg), b_out.data_ptr(),
        z_out.data_ptr(), act_out.data_ptr(), N, K, int(steps),
        _cuda.stream())
    return b_out, z_out, act_out


def fused_cd_steps_plain(b, z, active, S, alpha, tol_k, steps=8,
                         kernel_precision="f32", nonneg=False, l2=0.0):
    """The plain version of :func:`fused_cd_steps`, on any device: the
    twin of the JAX package's ``cd_steps_reference`` in the fused kernel's
    form (``z_k + act * dz``, the shrink times ``1 / (1 + l2)``, ``b``
    updated by one fused multiply-add), with the row of the true S
    (``'f32'``) or of bf16-rounded S (``'bf16'``)."""
    check_kernel_precision(kernel_precision)
    dev = b.device
    rows = S if kernel_precision == "f32" else round_bf16(S)
    alpha = _f32(alpha, dev)
    tol = _f32(tol_k, dev)
    scale = _scale(l2).to(dev)
    prox = soft_threshold_nonneg if nonneg else soft_threshold
    for _ in range(steps):
        diff = prox(b, alpha) * scale - z
        k = torch.argmax(torch.abs(diff), dim=1, keepdim=True)   # [N, 1]
        dz = torch.gather(diff, 1, k)
        upd = active * dz
        b = torch.addcmul(b, upd, rows[k[:, 0]])
        z = z.scatter_add(1, k, upd)
        active = active * (torch.abs(dz) > tol).to(torch.float32)
    return b, z, active


def fused_cd_mod_sweep(z, R, converged, weight, norm_cols, alpha, l2=0.0):
    """One cyclic coordinate-descent sweep over all K components.

    z, R: [N, K] / [N, D]; converged: [N] bool (frozen rows); weight:
    [D, K]; norm_cols: [K] squared column norms; alpha, l2: scalars.
    Returns ``(z, R, z_max, d_z_max)`` as new tensors, with the meanings
    of the JAX package's sweep. On a CUDA tensor the kernel reads W
    transposed, ``[K, D]``, so that each atom is one contiguous row, and
    each chunk's Gram entries and divisors from a scratch buffer that its
    prologue fills first; a CPU tensor runs the plain version at the
    kernel's chunk.
    """
    if z.device.type == "cpu":
        return fused_cd_mod_sweep_plain(z, R, converged, weight, norm_cols,
                                        alpha, l2)
    N, K = z.shape
    D = weight.shape[0]
    wt = weight.T.contiguous()
    nrm = norm_cols.to(torch.float32).contiguous()
    act = (~converged).to(torch.float32)
    _cuda.check_cuda(z=z, R=R, weight=wt, norm_cols=nrm, converged=act)
    _cuda.check_shapes({"R": (R, (N, D)), "weight": (weight, (D, K)),
                   "norm_cols": (nrm, (K,)), "converged": (act, (N,))})
    if min(N, D, K) == 0:
        raise ValueError(f"empty problem N={N}, D={D}, K={K}")
    gram = torch.empty((_cuda.load("cd").cd_mod_gram_floats(K),),
                       dtype=torch.float32, device=z.device)
    z_out, R_out = torch.empty_like(z), torch.empty_like(R)
    zmax = torch.empty((N,), dtype=torch.float32, device=z.device)
    dzmax = torch.empty_like(zmax)
    CD_MOD_SWEEP(z.data_ptr(), R.data_ptr(), act.data_ptr(), wt.data_ptr(),
                 nrm.data_ptr(), float(_f32(alpha)), float(_f32(l2)),
                 gram.data_ptr(), z_out.data_ptr(), R_out.data_ptr(),
                 zmax.data_ptr(), dzmax.data_ptr(), N, D, K, _cuda.stream())
    return z_out, R_out, zmax, dzmax


def fused_cd_mod_sweep_plain(z, R, converged, weight, norm_cols, alpha,
                             l2=0.0, tj=SWEEP_TJ):
    """The plain version of :func:`fused_cd_mod_sweep`, on any device, over
    chunks of ``tj`` atoms as the kernel takes them: ``P = R W_c`` at the
    chunk's start, then per atom j of the chunk the JAX kernel's fused form,
    ``rho = P_j + add ||w_j||^2`` and ``P_l += (add - sub) G[j, l]`` for the
    chunk's later atoms l (``G = W_c^T W_c``; fused multiply-adds), then
    ``R += C W_c^T``. With ``tj=1`` this is one dot product and one rank-1
    correction of R per atom, the order of the unblocked sweep."""
    N, K = z.shape
    z = z.clone()
    act_s = (~converged).to(torch.float32)
    zmax = torch.zeros((N,), dtype=torch.float32, device=z.device)
    dzmax = torch.zeros_like(zmax)
    for j0 in range(0, K, tj):
        Wc = weight[:, j0:j0 + tj]                                # [D, t]
        t = Wc.shape[1]
        P = R @ Wc                                                # [N, t]
        G = Wc.T @ Wc
        C = torch.zeros_like(P)
        for jj in range(t):
            j = j0 + jj
            nj = norm_cols[j]
            act = act_s * (nj != 0).to(torch.float32)
            zj = z[:, j].clone()
            add = act * torch.where(zj != 0, zj, 0.0)
            rho = torch.addcmul(P[:, jj], add, nj)
            denom = torch.where(nj != 0, nj, 1.0) + l2
            z_new = soft_threshold(rho, alpha) / denom
            z_new = torch.where(act > 0, z_new, zj)
            sub = act * torch.where(z_new != 0, z_new, 0.0)
            C[:, jj] = add - sub
            P[:, jj + 1:] = torch.addcmul(P[:, jj + 1:], C[:, jj:jj + 1],
                                          G[jj, jj + 1:])
            z[:, j] = z_new
            dzmax = torch.maximum(dzmax, torch.abs(z_new - zj) * act)
            zmax = torch.maximum(zmax, torch.abs(z_new) * act)
        R = torch.addmm(R, C, Wc.T)
    return z, R, zmax, dzmax
