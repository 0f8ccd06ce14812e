"""Fused FISTA steps: hand-written CUDA kernels and their plain versions.

Counterpart of the JAX package's ``ops/fused_ista.py``. One FISTA step for the
batched lasso (x: [N, D], z: [N, K], dictionary W: [D, K]):

    y      = z + mom * (z - z_prev)          (momentum point)
    resid  = y W^T - x                       (contract K)
    grad   = resid W                         (contract D)
    z_next = prox(y - lr * grad, th) * 1/(1 + l2 * lr)
    delta  = sum |z_next - z|                (convergence statistic)

On a CUDA tensor each step is two kernels of ``csrc/fista.cu``, both on
the tensor cores (warpgroup MMA): :func:`fista_resid` (K1: the momentum
point and the residual, with the residual's bf16 split beside it) and
:func:`fista_grad_prox` (K2: the gradient with the prox, delta and the
restart test in its epilogue). :func:`fused_fista_step` and
:func:`fused_fista_multistep` issue them, one pair per sub-step, on the
current stream; a multistep call reads each sub-step's scalars from a
device ``[S, 4]`` table by index, with no host sync between sub-steps. The
kernels' bf16 operands (:class:`FistaOperands`: W's split in both layouts
and a buffer for the residual's split) are made once a call. Within a
multistep call with a scalar momentum, each K2 also writes the next
sub-step's momentum point as its bf16 split, and the next K1 reads it in
place of forming y from z and z_prev (the same values).

On a CPU tensor the same functions run the plain PyTorch versions
(:func:`fista_resid_plain`, :func:`fista_grad_prox_plain`), which repeat
the kernels' arithmetic, bf16 rounding included. That is the only reason
the plain versions run: a CUDA tensor always takes the kernel, and a
tensor on any other device raises.

``kernel_precision``:

* ``'f32'``: the TPU kernel's bf16x3 split. Each operand ``v`` of a
  product is split into ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, and
  the product is ``hi @ hi + lo @ hi + hi @ lo`` with FP32 sums (the
  dropped ``lo @ lo`` is about 2^-16 relative): three bf16 MMAs into one
  FP32 accumulator in the kernels, three FP32 products of bf16-grid
  values with TF32 off in the plain versions, which sum them in another
  order.
* ``'bf16'``: both operands of each product rounded to bf16, FP32
  accumulation: the semantics of the TPU kernel's native bf16 passes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16, split_bf16)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg

_P, _I = ctypes.c_void_p, ctypes.c_int
_RESID_ARGS = [_P] * 9 + [_I] * 3 + [_P]
_GRAD_PROX_ARGS = [_P] * 13 + [_I] * 4 + [_P]

# the C entries of csrc/fista.cu, one per kernel and precision
FISTA_RESID = {kp: _cuda.CudaKernel("fista", f"fista_resid_{kp}", _RESID_ARGS)
               for kp in ("f32", "bf16")}
FISTA_GRAD_PROX = {kp: _cuda.CudaKernel("fista", f"fista_grad_prox_{kp}",
                                        _GRAD_PROX_ARGS)
                   for kp in ("f32", "bf16")}
_TILE = 128   # rows and columns of a block tile of csrc/fista.cu
_DEPTH = 64   # depth of a stage of its products


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


def _up(v, m):
    return -(-v // m) * m


def _bf16_parts(a, kernel_precision):
    """``[P, ...]`` bfloat16: the split ``(hi, lo)`` of f32 ``a`` for
    ``'f32'`` (P = 2), or ``bf16(a)`` for ``'bf16'`` (P = 1)."""
    parts = (split_bf16(a) if kernel_precision == "f32"
             else (round_bf16(a),))
    return torch.stack(parts).to(torch.bfloat16)


class FistaOperands(NamedTuple):
    """The kernels' bf16 operands for one dictionary and batch size, made
    by :func:`fista_operands` once a call. P is 2 (hi, lo) for ``'f32'``,
    1 for ``'bf16'``; X128 is X rounded up to a multiple of 128.

    ``w`` ``[P, D128, K64]``: W's split, K1's B operand (contiguous along
    K). ``wt`` ``[P, K128, D64]``: W^T's split, K2's B operand (contiguous
    along D). ``rb`` ``[P, N, D64]``: the residual's split, zero past D,
    which K1 writes beside the residual and K2 reads, so a
    :func:`fista_grad_prox` given these operands reads ``rb`` as the split
    of its ``resid``. ``ys`` ``[P, N, K64]`` (zero past K) or None: the
    next momentum point's split, which K2 writes when given the next
    step's scalars and K1 reads in place of forming y from z and z_prev
    (the sub-steps of a multistep call with a scalar momentum).
    """
    w: torch.Tensor
    wt: torch.Tensor
    rb: torch.Tensor
    ys: Optional[torch.Tensor] = None


def fista_operands(weight, n, kernel_precision="f32", with_y=False):
    """The :class:`FistaOperands` of ``weight`` [D, K] for batches of
    ``n`` rows: W split once, as the TPU wrapper splits it outside its
    kernel (fused_ista.py:210, :412), zero-padded to whole tiles; with
    ``with_y`` also the zeroed ``ys``."""
    check_kernel_precision(kernel_precision)
    D, K = weight.shape
    parts = _bf16_parts(weight, kernel_precision)
    pad = torch.nn.functional.pad
    w = pad(parts, (0, _up(K, _DEPTH) - K, 0, _up(D, _TILE) - D))
    wt = pad(parts.transpose(1, 2),
             (0, _up(D, _DEPTH) - D, 0, _up(K, _TILE) - K))
    P, dev = parts.shape[0], weight.device
    rb = torch.empty((P, n, _up(D, _DEPTH)), dtype=torch.bfloat16,
                     device=dev)
    ys = (torch.zeros((P, n, _up(K, _DEPTH)), dtype=torch.bfloat16,
                      device=dev) if with_y else None)
    return FistaOperands(w.contiguous(), wt.contiguous(), rb, ys)


def _fill_resid_split(ops, resid, kernel_precision):
    """Write ``resid``'s split into ``ops.rb`` (what K1 writes beside the
    residual), for a K2 call given the residual alone."""
    D = resid.shape[1]
    ops.rb[:, :, :D].copy_(_bf16_parts(resid, kernel_precision))
    ops.rb[:, :, D:].zero_()


def _check_operands(ops, N, D, K, kernel_precision):
    P = 2 if kernel_precision == "f32" else 1
    _cuda.check_cuda(bfloat16=("w", "wt", "rb", "ys"), w=ops.w, wt=ops.wt,
                     rb=ops.rb, ys=ops.ys)
    _cuda.check_shapes({
        "operands.w": (ops.w, (P, _up(D, _TILE), _up(K, _DEPTH))),
        "operands.wt": (ops.wt, (P, _up(K, _TILE), _up(D, _DEPTH))),
        "operands.rb": (ops.rb, (P, N, _up(D, _DEPTH))),
        "operands.ys": (ops.ys, (P, N, _up(K, _DEPTH)))})


def _y_split(ops, wanted, what):
    """``ops.ys`` when ``wanted``, else None; wanted without it raises."""
    if not wanted:
        return None
    if ops is None or ops.ys is None:
        raise ValueError(f"{what} needs operands made with with_y=True")
    return ops.ys


def _product(a, b, kernel_precision):
    """``a @ b`` as the kernels compute it: bf16 operands with FP32 sums,
    in ``'f32'`` the bf16x3 split ``hi @ hi + lo @ hi + hi @ lo``."""
    if a.is_cuda:
        require_fp32_matmul()
    if kernel_precision == "bf16":
        return round_bf16(a) @ round_bf16(b)
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def fista_resid_plain(x, z, z_prev, weight, scal, t_vec=None,
                      kernel_precision="f32"):
    """Plain version of K1: ``(z + c (z - z_prev)) W^T - x`` with ``c``
    the momentum ``scal[2]``, or the per-row restart coefficient of
    ``t_vec``, the product as :func:`_product` computes it."""
    c = scal[2] if t_vec is None else _restart_coef(t_vec)[0]
    y = z + c * (z - z_prev)
    return _product(y, weight.T, kernel_precision) - x


def fista_grad_prox_plain(resid, z, z_prev, weight, scal, trow=None,
                          t_vec=None, nonneg=False, kernel_precision="f32"):
    """Plain version of K2. Returns ``(z_next, delta, t_new)``; ``t_new``
    is None without ``t_vec``."""
    lr, th, scale = scal[0], scal[1], scal[3]
    c, t_next = ((scal[2], None) if t_vec is None
                 else _restart_coef(t_vec))
    y = z + c * (z - z_prev)
    grad = _product(resid, weight, kernel_precision)
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
                kernel_precision="f32", out=None, operands=None,
                y_split=False):
    """K1: ``r = y W^T - x`` with ``y = z + c (z - z_prev)``.

    ``scal`` is one ``[4]`` row of the scalar table; ``c`` is ``scal[2]``,
    or the restart coefficient of the ``[N, 1]`` carry ``t_vec``. On a CPU
    tensor this runs :func:`fista_resid_plain`; otherwise it launches the
    kernel into ``out`` (or a new ``[N, D]`` tensor) or raises.
    ``operands`` (:func:`fista_operands` of ``weight``, made here when
    None) carries W's split, and the kernel writes r's split into its
    ``rb`` for the :func:`fista_grad_prox` call given the same operands.
    With ``y_split`` the kernel reads y's split from ``operands.ys``, as
    the previous :func:`fista_grad_prox` given ``next_scal`` wrote it, in
    place of forming y (the same values); the plain version forms y.
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
    ops = (fista_operands(weight, N, kernel_precision) if operands is None
           else operands)
    _check_operands(ops, N, D, K, kernel_precision)
    ys = _y_split(ops, y_split, "y_split")
    FISTA_RESID[kernel_precision](
        x.data_ptr(), z.data_ptr(), z_prev.data_ptr(), ops.w.data_ptr(),
        scal.data_ptr(), _cuda.ptr(t_vec), out.data_ptr(), ops.rb.data_ptr(),
        _cuda.ptr(ys), N, D, K, _cuda.stream())
    return out


def fista_grad_prox(resid, z, z_prev, weight, scal, trow=None, t_vec=None,
                    nonneg=False, kernel_precision="f32", out=None,
                    with_delta=True, advance_t=True, operands=None,
                    next_scal=None):
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
    raises. The kernel reads ``resid``'s split from ``operands.rb``, as
    :func:`fista_resid` given the same ``operands`` wrote it; without
    ``operands`` they are made here and the split is taken from
    ``resid``. Given the next step's ``[4]`` scalar row ``next_scal`` (a
    scalar momentum: no ``t_vec``), the kernel also writes the next
    momentum point ``z_next + next_scal[2] (z_next - z)``'s split into
    ``operands.ys`` for the next :func:`fista_resid` with ``y_split``.
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
    _cuda.check_cuda(resid=resid, z=z, z_prev=z_prev, weight=weight,
                     scal=scal, trow=trow, t_vec=t_vec, out=out)
    _check_shapes(resid, z, z_prev, weight, scal, t_vec, trow, out)
    ops = operands
    if ops is None:
        ops = fista_operands(weight, N, kernel_precision)
        _fill_resid_split(ops, resid, kernel_precision)
    _check_operands(ops, N, D, K, kernel_precision)
    ys = _y_split(ops, next_scal is not None, "next_scal")
    if ys is not None:
        if t_vec is not None:
            raise ValueError("next_scal takes a scalar momentum, not t_vec")
        _cuda.check_cuda(next_scal=next_scal, z=z)
        _cuda.check_shapes({"next_scal": (next_scal, (4,))})
    delta = (torch.empty((1,), dtype=torch.float32, device=dev)
             if with_delta else None)
    rdot = counters = None
    if t_vec is not None and advance_t:
        rdot = torch.zeros((N,), dtype=torch.float32, device=dev)
        counters = torch.zeros((-(-N // _TILE),), dtype=torch.int32,
                               device=dev)
    FISTA_GRAD_PROX[kernel_precision](
        ops.rb.data_ptr(), z.data_ptr(), z_prev.data_ptr(), ops.wt.data_ptr(),
        scal.data_ptr(), _cuda.ptr(trow), _cuda.ptr(t_vec), _cuda.ptr(rdot),
        _cuda.ptr(counters), out.data_ptr(), _cuda.ptr(delta),
        _cuda.ptr(next_scal), _cuda.ptr(ys), N, D, K, int(nonneg),
        _cuda.stream())
    return out, (None if delta is None else delta.reshape(()))


def _grad_prox_plain_into(resid, z, z_prev, weight, scal, trow=None,
                          t_vec=None, nonneg=False, kernel_precision="f32",
                          out=None, with_delta=True, advance_t=True,
                          operands=None, next_scal=None):
    """:func:`fista_grad_prox_plain` with the calling convention of
    :func:`fista_grad_prox` (``t_vec`` advanced in place, ``out``;
    ``operands`` and ``next_scal`` are the kernels' and not read)."""
    z_next, delta, t_new = fista_grad_prox_plain(
        resid, z, z_prev, weight, scal, trow, t_vec, nonneg,
        kernel_precision)
    if t_vec is not None and advance_t:
        t_vec.copy_(t_new)
    if out is not None:
        z_next = out.copy_(z_next)
    return z_next, (delta if with_delta else None)


def _resid_plain_into(x, z, z_prev, weight, scal, t_vec=None,
                      kernel_precision="f32", out=None, operands=None,
                      y_split=False):
    return fista_resid_plain(x, z, z_prev, weight, scal, t_vec,
                             kernel_precision)


def _call_operands(x, weight, kernel_precision, with_y=False):
    """The :class:`FistaOperands` a call on the card makes once for all
    its sub-steps; None on the CPU, where the plain versions need none."""
    if x.device.type != "cuda":
        return None
    return fista_operands(weight, x.shape[0], kernel_precision, with_y)


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
    # with a scalar momentum each K2 forms the next sub-step's y for K1
    chain = t is None and steps > 1
    ops = (_call_operands(x, weight, kernel_precision, with_y=chain)
           if resid_fn is fista_resid else None)
    r = None
    cur, prev = z, z_prev
    delta = None
    for s in range(steps):
        r = resid_fn(x, cur, prev, weight, scal[s], t, kernel_precision,
                     out=r, operands=ops, y_split=chain and s > 0)
        z_new, delta = grad_prox_fn(
            r, cur, prev, weight, scal[s], trow, t, nonneg,
            kernel_precision, out=bufs[s % 2], with_delta=s == steps - 1,
            operands=ops,
            next_scal=scal[s + 1] if chain and s + 1 < steps else None)
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
    ops = _call_operands(x, weight, kernel_precision)
    r = fista_resid(x, z, z_prev, weight, scal[0],
                    kernel_precision=kernel_precision, operands=ops)
    return fista_grad_prox(r, z, z_prev, weight, scal[0], trow=trow,
                           nonneg=nonneg, kernel_precision=kernel_precision,
                           operands=ops)


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
