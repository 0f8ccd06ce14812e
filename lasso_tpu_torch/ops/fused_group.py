"""Fused group-lasso FISTA steps: a hand-written CUDA kernel and its plain
versions.

Counterpart of the JAX package's ``ops/fused_group.py``. One group-FISTA
step for x: [N, D], z: [N, K], W: [D, K] and a partition of the K
coordinates into G groups:

    y      = z + mom * (z - z_prev)             (or the restart momentum)
    v      = soft(y - lr * ((y W^T - x) W), l1) (v = y - lr * grad if no l1)
    z_next = v_g * max(1 - th_g / ||v_g||, 0)   per group (0 if ||v_g|| = 0)
    delta  = sum |z_next - z|

with ``th_g = alpha * lr * w_g``. On a CUDA tensor a step is three
launches on the current stream, with no host sync between sub-steps: K1
``fista_resid`` and K2 ``fista_grad_prox`` of ``csrc/fista.cu`` (K2 with
scale 1 writes v and reads the restart carry without advancing it), then
K5 ``group_prox`` of ``csrc/group.cu`` (:func:`group_prox_update`), which
applies the group shrink row by row, advances the restart carry and sums
delta.

The TPU kernel's one-hot ``[K, G_pad]`` membership pair and its 128-lane
group padding exist for its matrix unit only. The port describes the
groups by :class:`GroupTables`, built once per solve on the device by
:func:`build_group_tables`: ``perm`` (the coordinates sorted stably by
group id) and ``offsets`` (``[G+1]``) for the kernel, the ids (or the
block size of contiguous blocks) for the plain versions.

On a CPU tensor the same functions run the plain PyTorch versions
(:func:`group_prox_plain`, :func:`group_prox_update_plain`,
:func:`fused_group_fista_multistep_plain`), which repeat the kernels'
arithmetic, bf16 rounding included. That is the only reason the plain
versions run: a CUDA tensor always takes the kernels, and a tensor on any
other device raises.

``kernel_precision``:

* ``'f32'``: the products of :mod:`lasso_tpu_torch.ops.fused_ista` (the
  TPU kernel's bf16x3 split) and FP32 group sums of squares. The TPU
  kernel also splits v^2 and the group scale into bf16 hi + lo (about
  2^-17 relative); the port keeps those in f32.
* ``'bf16'``: bf16 operands of the products (as in
  :mod:`lasso_tpu_torch.ops.fused_ista`), each v^2 rounded to bf16 before
  the f32 group sum, and the group scale rounded to bf16 before it
  multiplies v: the TPU kernel's bf16 passes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.fused_ista import (_call_operands,
                                            _grad_prox_plain_into,
                                            _resid_plain_into, _restart_coef,
                                            _scalar_table, fista_grad_prox,
                                            fista_resid)
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16)

_P, _I = ctypes.c_void_p, ctypes.c_int

# the C entries of csrc/group.cu, one per precision
GROUP_PROX = {kp: _cuda.CudaKernel("group", f"group_prox_{kp}",
                                   [_P] * 11 + [_I] * 3 + [_P])
              for kp in ("f32", "bf16")}
_SMEM_BYTES = 227 * 1024   # shared memory of one H100 block


class GroupTables(NamedTuple):
    """A partition of K coordinates into G groups, on one device.

    ``perm`` (int32 ``[K]``, the coordinates sorted stably by group id) and
    ``offsets`` (int32 ``[G+1]``; group g is ``perm[offsets[g]:
    offsets[g+1]]``) are what the kernel reads; ``ids`` (int64 ``[K]``)
    and ``block`` (the size of contiguous equal blocks, else None) are
    what the plain versions read.
    """
    perm: torch.Tensor
    offsets: torch.Tensor
    ids: torch.Tensor
    block: Optional[int]

    @property
    def n_groups(self):
        return self.offsets.numel() - 1


def build_group_tables(ids, n_groups, device, block=None):
    """:class:`GroupTables` of the ``[K]`` group ids ``ids`` (numpy or a
    tensor; every id in ``[0, n_groups)``) on ``device``. ``block`` marks
    contiguous blocks of that size (``perm`` is then ``arange(K)``)."""
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids,
                     dtype=np.int64)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    offsets = np.zeros(n_groups + 1, np.int32)
    np.cumsum(np.bincount(ids, minlength=n_groups), out=offsets[1:])
    return GroupTables(torch.from_numpy(perm).to(device),
                       torch.from_numpy(offsets).to(device),
                       torch.from_numpy(ids).to(device), block)


def supports_fused_group_step(x, z0, weight, n_groups):
    """Shapes the fused path takes: the JAX package's lane grid (D and K
    multiples of 128, N of 8) in float32. The kernels mask ragged edges
    themselves; the grid is kept so that padding, and with it the stopping
    threshold and ``n_iter``, match the JAX package. The TPU's VMEM budget
    (the resident membership pair) has no counterpart; any G is taken."""
    N, D = x.shape
    K = weight.shape[1]
    return (D % 128 == 0 and K % 128 == 0 and N % 8 == 0
            and x.dtype == torch.float32)


def group_prox_plain(v, thg, tables, kernel_precision="f32"):
    """The group shrink ``v_g * max(1 - thg_g / ||v_g||, 0)`` of ``v``
    ``[N, K]`` (0 where ``||v_g|| = 0``), ``thg`` a scalar or a ``[G]``
    row: a reshape-sum for contiguous blocks, ``index_add_`` over the ids
    otherwise. ``'bf16'`` rounds each ``v^2`` and each group scale to bf16,
    as the kernel does. The double ``where`` around ``sqrt`` keeps reverse
    mode finite through zeroed groups."""
    check_kernel_precision(kernel_precision)
    N, K = v.shape
    G = tables.n_groups
    sq = v * v
    if kernel_precision == "bf16":
        sq = round_bf16(sq)
    if tables.block is not None:
        gsq = torch.sum(sq.reshape(N, G, tables.block), dim=-1)
    else:
        gsq = v.new_zeros((N, G)).index_add_(1, tables.ids, sq)
    nz = gsq > 0.0
    norms = torch.where(nz, torch.sqrt(torch.where(nz, gsq, 1.0)), 0.0)
    scale = torch.where(
        nz, torch.clamp_min(1.0 - thg / torch.where(nz, norms, 1.0), 0.0),
        0.0)
    if kernel_precision == "bf16":
        scale = round_bf16(scale)
    if tables.block is not None:
        return (v.reshape(N, G, tables.block) * scale[..., None]).reshape(N, K)
    return v * scale[:, tables.ids]


def group_prox_update_plain(v, z, z_prev, t_vec, thg, tables,
                            kernel_precision="f32"):
    """Plain version of K5. Returns ``(z_next, delta, t_new)``: the group
    shrink of ``v``, ``sum|z_next - z|``, and with the ``[N, 1]`` restart
    carry ``t_vec`` its next value (``1`` where ``<y - z_next, z_next - z>
    > 0`` with ``y = z + c (z - z_prev)``, else ``t_next``; None without
    ``t_vec``)."""
    z_next = group_prox_plain(v, thg, tables, kernel_precision)
    delta = torch.sum(torch.abs(z_next - z))
    t_new = None
    if t_vec is not None:
        c, t_next = _restart_coef(t_vec)
        y = z + c * (z - z_prev)
        rdot = torch.sum((y - z_next) * (z_next - z), dim=1, keepdim=True)
        t_new = torch.where(rdot > 0, 1.0, t_next)
    return z_next, delta, t_new


def _group_prox_update_plain_into(v, z, z_prev, t_vec, thg, tables,
                                  kernel_precision="f32", out=None,
                                  with_delta=True):
    """:func:`group_prox_update_plain` with the calling convention of
    :func:`group_prox_update` (``t_vec`` advanced in place, ``out``)."""
    z_next, delta, t_new = group_prox_update_plain(
        v, z, z_prev, t_vec, thg, tables, kernel_precision)
    if t_vec is not None:
        t_vec.copy_(t_new)
    if out is not None:
        z_next = out.copy_(z_next)
    return z_next, (delta if with_delta else None)


def group_prox_update(v, z, z_prev, t_vec, thg, tables,
                      kernel_precision="f32", out=None, with_delta=True):
    """K5: ``z_next`` = the group shrink of ``v`` (thresholds ``thg``,
    ``[G]``); with the ``[N, 1]`` restart carry ``t_vec``, ``t_vec`` is
    advanced in place from ``y = z + c (z - z_prev)``. ``out`` may be
    ``z_prev`` itself. Returns ``(z_next, delta)``, ``delta = sum|z_next -
    z|`` as a 0-d tensor (None when ``with_delta`` is False). On a CPU
    tensor this runs the plain version; otherwise it launches the kernel
    or raises."""
    check_kernel_precision(kernel_precision)
    if v.device.type == "cpu":
        return _group_prox_update_plain_into(v, z, z_prev, t_vec, thg,
                                             tables, kernel_precision, out,
                                             with_delta)
    N, K = v.shape
    G = tables.n_groups
    dev = v.device
    if out is None:
        out = torch.empty((N, K), dtype=torch.float32, device=dev)
    delta = partials = counter = None
    if with_delta:
        delta = torch.empty((1,), dtype=torch.float32, device=dev)
        partials = torch.empty((N,), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    _cuda.check_cuda(int32=("perm", "offsets"), v=v, z=z, z_prev=z_prev,
                     t_vec=t_vec, thg=thg, out=out, perm=tables.perm,
                     offsets=tables.offsets)
    _cuda.check_shapes({"z": (z, (N, K)), "z_prev": (z_prev, (N, K)),
                        "t_vec": (t_vec, (N, 1)), "thg": (thg, (G,)),
                        "out": (out, (N, K)), "perm": (tables.perm, (K,))})
    if min(N, K, G) == 0:
        raise ValueError(f"empty problem N={N}, K={K}, G={G}")
    if 4 * K > _SMEM_BYTES:
        raise ValueError(f"K={K}: one row exceeds a block's shared memory")
    GROUP_PROX[kernel_precision](
        v.data_ptr(), z.data_ptr(), z_prev.data_ptr(), _cuda.ptr(t_vec),
        tables.perm.data_ptr(), tables.offsets.data_ptr(), thg.data_ptr(),
        out.data_ptr(), _cuda.ptr(partials), _cuda.ptr(counter),
        _cuda.ptr(delta), N, K, G, _cuda.stream())
    return out, (None if delta is None else delta.reshape(()))


def _run_group_steps(resid_fn, grad_fn, prox_fn, x, z, z_prev, weight, lr,
                     thg_row, l1_thresh, moms, tables, steps,
                     kernel_precision, t_vec, use_l1):
    """The sub-step loop of :func:`fused_group_fista_multistep`, over a K1,
    a K2 and a K5 function (the kernels' wrappers, or their plain
    versions)."""
    check_kernel_precision(kernel_precision)
    # K2 with threshold l1 * lr and scale 1 writes v; soft(u, 0) == u
    scal = _scalar_table(lr, l1_thresh if use_l1 else 0.0, moms, 0.0, steps,
                         x.device)
    thg = torch.as_tensor(thg_row, dtype=torch.float32).to(
        x.device).reshape(-1).contiguous()
    t = (None if t_vec is None else
         t_vec.to(torch.float32, memory_format=torch.contiguous_format,
                  copy=True))
    # three buffers rotate, so that K5 never writes over the z_prev it
    # reads for the restart test: on the H100 that aliasing made it 4x
    # slower (PERF.md, PR 4)
    bufs = tuple(torch.empty_like(z) for _ in range(3))
    v = torch.empty_like(z)
    ops = (_call_operands(x, weight, kernel_precision)
           if resid_fn is fista_resid else None)
    r = None
    cur, prev = z, z_prev
    delta = None
    for s in range(steps):
        r = resid_fn(x, cur, prev, weight, scal[s], t, kernel_precision,
                     out=r, operands=ops)
        grad_fn(r, cur, prev, weight, scal[s], None, t, False,
                kernel_precision, out=v, with_delta=False, advance_t=False,
                operands=ops)
        z_new, delta = prox_fn(v, cur, prev, t, thg, tables,
                               kernel_precision, out=bufs[s % 3],
                               with_delta=s == steps - 1)
        cur, prev = z_new, cur
    if t_vec is not None:
        return cur, prev, t, delta
    return cur, prev, delta


def fused_group_fista_multistep(x, z, z_prev, weight, lr, thg_row,
                                l1_thresh, moms, tables, steps,
                                kernel_precision="f32", t_vec=None,
                                use_l1=False):
    """``steps`` group-FISTA iterations in one call.

    ``thg_row``: the ``[G]`` group thresholds ``alpha * lr * w_g``;
    ``l1_thresh``: the sparse-group l1 threshold ``l1_alpha * lr``, used
    only with ``use_l1``; ``moms``: a scalar or ``[steps]`` momentum
    coefficients (ignored under the ``t_vec`` per-row restart; the
    conventions of
    :func:`lasso_tpu_torch.ops.fused_ista.fused_fista_multistep`);
    ``tables``: the :class:`GroupTables` of the groups, in place of the
    TPU kernel's membership pair. The TPU arguments ``block_n`` and
    ``interpret`` have no counterpart: the device of ``x`` picks the
    kernels or the plain versions.

    Returns ``(z_final, z_penultimate, [t_out,] delta)``, ``delta`` of the
    last sub-step. The sub-steps rotate three ``[N, K]`` buffers; the
    inputs are never written.
    """
    if x.is_cuda:
        _cuda.WRAPPER_CALLS["fused_group_fista_multistep"] += 1
    return _run_group_steps(fista_resid, fista_grad_prox, group_prox_update,
                            x, z, z_prev, weight, lr, thg_row, l1_thresh,
                            moms, tables, steps, kernel_precision, t_vec,
                            use_l1)


def fused_group_fista_multistep_plain(x, z, z_prev, weight, lr, thg_row,
                                      l1_thresh, moms, tables, steps,
                                      kernel_precision="f32", t_vec=None,
                                      use_l1=False):
    """The plain version of :func:`fused_group_fista_multistep`, on any
    device."""
    return _run_group_steps(_resid_plain_into, _grad_prox_plain_into,
                            _group_prox_update_plain_into, x, z, z_prev,
                            weight, lr, thg_row, l1_thresh, moms, tables,
                            steps, kernel_precision, t_vec, use_l1)
