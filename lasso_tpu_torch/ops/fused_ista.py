"""Fused FISTA steps: hand-written CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/fused_ista.py``. One FISTA step for the
batched lasso (x: [N, D], z: [N, K], dictionary W: [D, K]):

    y      = z + mom * (z - z_prev)          (momentum point)
    resid  = y W^T - x                       (contract K)
    grad   = resid W                         (contract D)
    z_next = prox(y - lr * grad, th) * 1/(1 + l2 * lr)
    delta  = sum |z_next - z|                (convergence statistic)

On a CUDA tensor each step is two kernels of ``csrc/fista.cu``:
:func:`fista_resid` (K1: the momentum point and the residual) and
:func:`fista_grad_prox` (K2: the gradient with the prox, delta and the
restart test in its epilogue). :func:`fused_fista_step` and
:func:`fused_fista_multistep` issue them, one pair per sub-step, on the
current stream; a multistep call reads each sub-step's scalars from a
device ``[S, 4]`` table by index, with no host sync between sub-steps.

On a CPU tensor the same functions run the plain PyTorch versions
(:func:`fista_resid_plain`, :func:`fista_grad_prox_plain`), which repeat
the kernels' arithmetic, bf16 rounding included. That is the only reason
the plain versions run: a CUDA tensor always takes the kernel, and a
tensor on any other device raises.

``kernel_precision``:

* ``'f32'``: FP32 products (FMA in the kernels, TF32 off in the plain
  version). The JAX package's TPU kernel emulates f32 with a bf16x3
  split; the port's f32 is at least as accurate.
* ``'bf16'``: both operands of each product rounded to bf16, FP32
  accumulation: the semantics of the TPU kernel's native bf16 passes.
"""

from __future__ import annotations

import ctypes

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg

_P, _I = ctypes.c_void_p, ctypes.c_int
_RESID_ARGS = [_P] * 7 + [_I] * 3 + [_P]
_GRAD_PROX_ARGS = [_P] * 11 + [_I] * 4 + [_P]

# the C entries of csrc/fista.cu, one per kernel and precision
FISTA_RESID = {kp: _cuda.CudaKernel("fista", f"fista_resid_{kp}", _RESID_ARGS)
               for kp in ("f32", "bf16")}
FISTA_GRAD_PROX = {kp: _cuda.CudaKernel("fista", f"fista_grad_prox_{kp}",
                                        _GRAD_PROX_ARGS)
                   for kp in ("f32", "bf16")}
_ROW_TILE = 128   # BM of csrc/fista.cu: rows per block


def supports_fused_step(x, z0, weight):
    """Shapes the fused path takes: the JAX package's lane grid (D and K
    multiples of 128, N of 8) in float32. The CUDA kernels mask ragged
    edges themselves; the grid is kept so that padding, and with it the
    stopping threshold and ``n_iter``, match the JAX package."""
    N, D = x.shape
    K = weight.shape[1]
    return (D % 128 == 0 and K % 128 == 0 and N % 8 == 0
            and x.dtype == torch.float32)


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def _scalar_table(lrs, threshs, moms, l2, steps, device):
    """The ``[steps, 4]`` table of per-sub-step scalars (lr, threshold,
    momentum, 1/(1 + l2*lr)) in float32, built where its inputs are and
    copied to ``device`` once."""
    vals = [_f32(v) for v in (lrs, threshs, moms, l2)]
    where = next((v.device for v in vals if v.device.type != "cpu"),
                 torch.device("cpu"))
    lr, th, mom, l2 = (torch.broadcast_to(v.to(where), (steps,))
                       for v in vals)
    table = torch.stack([lr, th, mom, 1.0 / (1.0 + l2 * lr)], dim=1)
    return table.to(device).contiguous()


def _restart_coef(t):
    """Per-row restart momentum ``(t - 1) / t_next`` and ``t_next`` for the
    carry ``t`` (t_{k-1}, init 0)."""
    t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) * 0.5
    return (t - 1.0) / t_next, t_next


def _matmul_f32(a, b):
    if a.is_cuda:
        require_fp32_matmul()
    return a @ b


def fista_resid_plain(x, z, z_prev, weight, scal, t_vec=None,
                      kernel_precision="f32"):
    """Plain version of K1: ``(z + c (z - z_prev)) W^T - x`` with ``c``
    the momentum ``scal[2]``, or the per-row restart coefficient of
    ``t_vec``."""
    c = scal[2] if t_vec is None else _restart_coef(t_vec)[0]
    y = z + c * (z - z_prev)
    w = weight
    if kernel_precision == "bf16":
        y, w = round_bf16(y), round_bf16(w)
    return _matmul_f32(y, w.T) - x


def fista_grad_prox_plain(resid, z, z_prev, weight, scal, trow=None,
                          t_vec=None, nonneg=False, kernel_precision="f32"):
    """Plain version of K2. Returns ``(z_next, delta, t_new)``; ``t_new``
    is None without ``t_vec``."""
    lr, th, scale = scal[0], scal[1], scal[3]
    c, t_next = ((scal[2], None) if t_vec is None
                 else _restart_coef(t_vec))
    y = z + c * (z - z_prev)
    r, w = resid, weight
    if kernel_precision == "bf16":
        r, w = round_bf16(r), round_bf16(w)
    grad = _matmul_f32(r, w)
    prox = soft_threshold_nonneg if nonneg else soft_threshold
    z_next = prox(y - lr * grad, th if trow is None else trow) * scale
    delta = torch.sum(torch.abs(z_next - z))
    t_new = None
    if t_vec is not None:
        rdot = torch.sum((y - z_next) * (z_next - z), dim=1, keepdim=True)
        t_new = torch.where(rdot > 0, 1.0, t_next)
    return z_next, delta, t_new


def _check_shapes(x, z, z_prev, weight, scal, t_vec=None, trow=None,
                  out=None):
    N, D = x.shape
    K = weight.shape[1]
    want = {"z": (z, (N, K)), "z_prev": (z_prev, (N, K)),
            "weight": (weight, (D, K)), "scal": (scal, (4,)),
            "t_vec": (t_vec, (N, 1)), "trow": (trow, (1, K)),
            "out": (out, (N, K))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if min(N, D, K) == 0:
        raise ValueError(f"empty problem N={N}, D={D}, K={K}")


def fista_resid(x, z, z_prev, weight, scal, t_vec=None,
                kernel_precision="f32", out=None):
    """K1: ``r = y W^T - x`` with ``y = z + c (z - z_prev)``.

    ``scal`` is one ``[4]`` row of the scalar table; ``c`` is ``scal[2]``,
    or the restart coefficient of the ``[N, 1]`` carry ``t_vec``. On a CPU
    tensor this runs :func:`fista_resid_plain`; otherwise it launches the
    kernel into ``out`` (or a new ``[N, D]`` tensor) or raises.
    """
    check_kernel_precision(kernel_precision)
    if x.device.type == "cpu":
        return fista_resid_plain(x, z, z_prev, weight, scal, t_vec,
                                 kernel_precision)
    N, D = x.shape
    K = weight.shape[1]
    if out is None:
        out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    _cuda.check_cuda(x=x, z=z, z_prev=z_prev, weight=weight, scal=scal,
                     t_vec=t_vec, out=out)
    _check_shapes(x, z, z_prev, weight, scal, t_vec)
    if tuple(out.shape) != (N, D):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(N, D)}")
    FISTA_RESID[kernel_precision](
        x.data_ptr(), z.data_ptr(), z_prev.data_ptr(), weight.data_ptr(),
        scal.data_ptr(), _cuda.ptr(t_vec), out.data_ptr(), N, D, K,
        _cuda.stream())
    return out


def fista_grad_prox(resid, z, z_prev, weight, scal, trow=None, t_vec=None,
                    nonneg=False, kernel_precision="f32", out=None,
                    with_delta=True, advance_t=True):
    """K2: ``z_next = prox(y - lr (resid W), th) * scale``.

    ``trow`` is a ``[1, K]`` threshold row (already times lr) in place of
    ``scal[1]``. With the ``[N, 1]`` restart carry ``t_vec``, ``t_vec`` is
    advanced in place (``t = 1`` where ``<y - z_next, z_next - z> > 0``,
    else ``t_next``); with ``advance_t=False`` it is only read for the
    momentum (the group path advances it after its group shrink).
    ``out`` may be ``z_prev`` itself. Returns
    ``(z_next, delta)``, ``delta = sum|z_next - z|`` as a 0-d tensor (None
    when ``with_delta`` is False). On a CPU tensor this runs
    :func:`fista_grad_prox_plain`; otherwise it launches the kernel or
    raises.
    """
    check_kernel_precision(kernel_precision)
    if resid.device.type == "cpu":
        return _grad_prox_plain_into(resid, z, z_prev, weight, scal, trow,
                                     t_vec, nonneg, kernel_precision, out,
                                     with_delta, advance_t)
    N, D = resid.shape
    K = weight.shape[1]
    dev = resid.device
    if out is None:
        out = torch.empty((N, K), dtype=torch.float32, device=dev)
    delta = (torch.empty((1,), dtype=torch.float32, device=dev)
             if with_delta else None)
    rdot = counters = None
    if t_vec is not None and advance_t:
        rdot = torch.zeros((N,), dtype=torch.float32, device=dev)
        counters = torch.zeros((-(-N // _ROW_TILE),), dtype=torch.int32,
                               device=dev)
    _cuda.check_cuda(resid=resid, z=z, z_prev=z_prev, weight=weight,
                     scal=scal, trow=trow, t_vec=t_vec, out=out)
    _check_shapes(resid, z, z_prev, weight, scal, t_vec, trow, out)
    FISTA_GRAD_PROX[kernel_precision](
        resid.data_ptr(), z.data_ptr(), z_prev.data_ptr(), weight.data_ptr(),
        scal.data_ptr(), _cuda.ptr(trow), _cuda.ptr(t_vec), _cuda.ptr(rdot),
        _cuda.ptr(counters), out.data_ptr(), _cuda.ptr(delta), N, D, K,
        int(nonneg), _cuda.stream())
    return out, (None if delta is None else delta.reshape(()))


def _grad_prox_plain_into(resid, z, z_prev, weight, scal, trow=None,
                          t_vec=None, nonneg=False, kernel_precision="f32",
                          out=None, with_delta=True, advance_t=True):
    """:func:`fista_grad_prox_plain` with the calling convention of
    :func:`fista_grad_prox` (``t_vec`` advanced in place, ``out``)."""
    z_next, delta, t_new = fista_grad_prox_plain(
        resid, z, z_prev, weight, scal, trow, t_vec, nonneg,
        kernel_precision)
    if t_vec is not None and advance_t:
        t_vec.copy_(t_new)
    if out is not None:
        z_next = out.copy_(z_next)
    return z_next, (delta if with_delta else None)


def _resid_plain_into(x, z, z_prev, weight, scal, t_vec=None,
                      kernel_precision="f32", out=None):
    return fista_resid_plain(x, z, z_prev, weight, scal, t_vec,
                             kernel_precision)


def _step_operands(x, weight, lr, alpha, mom, l2):
    """Scalar table ``[1, 4]`` and threshold row (or None) of one step."""
    a = _f32(alpha)
    has_row = a.ndim > 0
    lr_f = _f32(lr)
    scal = _scalar_table(lr_f, (0.0 if has_row else a) * lr_f, mom, l2, 1,
                         x.device)
    trow = None
    if has_row:
        trow = (a.to(x.device).reshape(1, weight.shape[1])
                * lr_f.to(x.device)).contiguous()
    return scal, trow


def _run_steps(resid_fn, grad_prox_fn, x, z, z_prev, weight, lrs, threshs,
               moms, steps, kernel_precision, t_vec, nonneg, l2):
    """The sub-step loop of :func:`fused_fista_multistep`, over a K1 and a
    K2 function (the kernels' wrappers, or their plain versions)."""
    check_kernel_precision(kernel_precision)
    th = _f32(threshs)
    has_row = th.ndim == 2
    scal = _scalar_table(lrs, 0.0 if has_row else th, moms, l2, steps,
                         x.device)
    trow = (th.to(x.device).reshape(1, weight.shape[1]).contiguous()
            if has_row else None)
    t = (None if t_vec is None else
         t_vec.to(torch.float32, memory_format=torch.contiguous_format,
                  copy=True))
    bufs = (torch.empty_like(z), torch.empty_like(z))
    r = None
    cur, prev = z, z_prev
    delta = None
    for s in range(steps):
        r = resid_fn(x, cur, prev, weight, scal[s], t, kernel_precision,
                     out=r)
        z_new, delta = grad_prox_fn(
            r, cur, prev, weight, scal[s], trow, t, nonneg,
            kernel_precision, out=bufs[s % 2], with_delta=s == steps - 1)
        cur, prev = z_new, cur
    if t_vec is not None:
        return cur, prev, t, delta
    return cur, prev, delta


def fused_fista_step(x, z, z_prev, weight, lr, alpha, mom,
                     kernel_precision="f32", nonneg=False, l2=0.0):
    """One fused FISTA step. Returns ``(z_next, delta)`` where
    ``delta = sum|z_next - z|`` (a 0-d tensor on x's device).

    ``alpha`` is a scalar or a per-feature ``[1, K]`` row (weighted
    lasso); ``mom`` is the momentum coefficient of this step's y (lagged
    one iteration relative to the t-update, see
    :mod:`lasso_tpu_torch.linear.solvers.ista`). ``l2 > 0`` adds the
    elastic-net contraction ``1/(1 + l2*lr)`` after the shrink. The TPU
    arguments ``block_n`` and ``interpret`` have no counterpart: the
    device of ``x`` picks the kernels or the plain versions.
    """
    check_kernel_precision(kernel_precision)
    scal, trow = _step_operands(x, weight, lr, alpha, mom, l2)
    if x.is_cuda:
        _cuda.WRAPPER_CALLS["fused_fista_step"] += 1
    r = fista_resid(x, z, z_prev, weight, scal[0],
                    kernel_precision=kernel_precision)
    return fista_grad_prox(r, z, z_prev, weight, scal[0], trow=trow,
                           nonneg=nonneg, kernel_precision=kernel_precision)


def fused_fista_step_plain(x, z, z_prev, weight, lr, alpha, mom,
                           kernel_precision="f32", nonneg=False, l2=0.0):
    """The plain version of :func:`fused_fista_step`, on any device."""
    check_kernel_precision(kernel_precision)
    scal, trow = _step_operands(x, weight, lr, alpha, mom, l2)
    r = fista_resid_plain(x, z, z_prev, weight, scal[0],
                          kernel_precision=kernel_precision)
    z_next, delta, _ = fista_grad_prox_plain(
        r, z, z_prev, weight, scal[0], trow=trow, nonneg=nonneg,
        kernel_precision=kernel_precision)
    return z_next, delta


def fused_fista_multistep(x, z, z_prev, weight, lrs, threshs, moms, steps,
                          kernel_precision="f32", t_vec=None, nonneg=False,
                          l2=0.0):
    """``steps`` FISTA iterations in one call.

    ``lrs``/``threshs``/``moms`` are scalars or length-``steps`` vectors of
    the per-sub-step learning rate, shrink threshold (alpha*lr) and
    momentum coefficient (the same lagged-one convention as
    :func:`fused_fista_step`). ``threshs`` may instead be a ``[1, K]``
    per-feature threshold row (already times lr), shared by every
    sub-step.

    Returns ``(z_final, z_penultimate, delta)``, with ``delta =
    sum|z_final - z_penultimate|`` of the last sub-step only.

    ``t_vec`` (``[N, 1]`` float32, carry convention t_{k-1} with init 0)
    switches to per-row adaptive-restart momentum: ``moms`` is ignored,
    each row advances its own t and resets it when its gradient-mapping
    test ``<y - z_new, z_new - z> > 0`` fires. The return is then
    ``(z_final, z_penultimate, t_out, delta)``.

    The sub-steps ping-pong between two ``[N, K]`` buffers: from the third
    sub-step on, z_new overwrites the iterate two steps back. The inputs
    are never written.
    """
    if x.is_cuda:
        _cuda.WRAPPER_CALLS["fused_fista_multistep"] += 1
    return _run_steps(fista_resid, fista_grad_prox, x, z, z_prev, weight,
                      lrs, threshs, moms, steps, kernel_precision, t_vec,
                      nonneg, l2)


def fused_fista_multistep_plain(x, z, z_prev, weight, lrs, threshs, moms,
                                steps, kernel_precision="f32", t_vec=None,
                                nonneg=False, l2=0.0):
    """The plain version of :func:`fused_fista_multistep`, on any
    device."""
    return _run_steps(_resid_plain_into, _grad_prox_plain_into, x, z,
                      z_prev, weight, lrs, threshs, moms, steps,
                      kernel_precision, t_vec, nonneg, l2)


def fista_step_reference(x, z, z_prev, weight, lr, alpha, mom,
                         precision=None, l2=0.0):
    """Plain FISTA step at a matmul precision (the unfused step of
    :func:`lasso_tpu_torch.linear.solvers.ista.ista`)."""
    from lasso_tpu_torch.ops.common import matmul
    y = z + mom * (z - z_prev)
    resid = matmul(y, weight.T, precision) - x
    grad = matmul(resid, weight, precision)
    z_next = soft_threshold(y - lr * grad, alpha * lr) / (1.0 + l2 * lr)
    return z_next, torch.sum(torch.abs(z_next - z))
