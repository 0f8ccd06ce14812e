"""Fused convolutional FISTA steps: hand-written CUDA kernels and their plain
versions.

Counterpart of the JAX package's ``ops/fused_conv.py``. One conv FISTA step
(x: [N, Cx, H, W], codes z: [N, Cz, Hz, Wz], dictionary W: [Cz, Cx, kh,
kw], stride 1, padding p on both axes, H = Hz + kh - 1 - 2p):

    y      = z + mom * (z - z_prev)               (momentum point)
    resid  = conv_transpose2d(y, W, p) - x        (the decoder's residual)
    grad   = conv2d(resid, W, p)                  (its adjoint)
    z_next = prox(y - lr * grad, th)
    delta  = sum |z_next - z|                     (convergence statistic)

On a CUDA tensor each step is two kernels of ``csrc/conv.cu``:
:func:`conv_decode_resid` (K9a: the momentum point and the residual) and
:func:`conv_adjoint_prox` (K9b: the adjoint with the prox, delta and the
restart test in its epilogue), both implicit GEMMs on Hopper's warpgroup
MMA. They read W's bf16 parts in the layouts :func:`conv_operands` makes,
once a call. :func:`fused_conv_fista_multistep` issues them, one pair per
sub-step, on the current stream, and reads each sub-step's scalars from a
device ``[S, 4]`` table by index, with no host sync between sub-steps.

On a CPU tensor the same functions run the plain PyTorch versions
(:func:`conv_decode_resid_plain`, :func:`conv_adjoint_prox_plain`), which
repeat the kernels' arithmetic, bf16 rounding and splits included; a CUDA
tensor always takes the kernel, and a tensor on any other device raises.

The TPU kernel works on a "canvas" layout built for the TPU's lanes
(``canvas_dims``, ``pack_*``, ``unpack_codes``, ``_k_mats`` in the JAX
package); the port works on ``[N, C, H, W]`` as it lies and has no
counterpart of them.

``kernel_precision``: ``'bf16'`` rounds y, the residual and W to bf16 and
sums in FP32, the TPU kernel's native bf16 passes; ``'f32'`` is the TPU
kernel's bf16x3 split (fused_conv.py:259-262, 300-303): each conv is
``hi*hi + lo*hi + hi*lo`` of the operands' bf16 parts with FP32 sums, in
the kernels and in the plain versions (three convolutions with TF32 off).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lasso_tpu_torch.config import require_fp32_conv
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.fused_ista import (_bf16_parts, _f32,
                                            _restart_coef, _scalar_table,
                                            _up)
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16, split_bf16)
from lasso_tpu_torch.ops.shrink import soft_threshold, soft_threshold_nonneg

_P, _I = ctypes.c_void_p, ctypes.c_int
_DECODE_ARGS = [_P] * 7 + [_I] * 8 + [_P]
_ADJOINT_ARGS = [_P] * 12 + [_I] * 10 + [_P]

# the C entries of csrc/conv.cu, one per kernel and precision
CONV_DECODE_RESID = {kp: _cuda.CudaKernel("conv", f"conv_decode_resid_{kp}",
                                          _DECODE_ARGS)
                     for kp in ("f32", "bf16")}
CONV_ADJOINT_PROX = {kp: _cuda.CudaKernel("conv", f"conv_adjoint_prox_{kp}",
                                          _ADJOINT_ARGS)
                     for kp in ("f32", "bf16")}

# csrc/conv.cu's operand layouts: the contraction padded to whole 16-deep
# MMA slices, the MMA's n dimension to 256 rows (the widest n tile)
_SLICE, _NPAD = 16, 256


def _n_g8(kw):
    """The TPU kernel's 8-row tap subgroups per (cx, ki) row: ceil(kw/8).
    Kept for the tap-row count that caps S (:func:`max_fuse_steps_conv`)."""
    return -(-kw // 8)


def max_fuse_steps_conv(weight):
    """Cap on the iterations fused per call: ``8192 // rows`` with ``rows =
    Cx * kh * ceil(kw/8) * 8``, the JAX package's rule (it bounds the
    TPU kernel's unrolled body). Kept as it is: S decides where the solver
    checks convergence, and with it ``n_iter``."""
    Cx, kh, kw = weight.shape[1], weight.shape[2], weight.shape[3]
    rows = Cx * kh * _n_g8(kw) * 8
    return max(1, 8192 // rows)


def supports_fused_conv(x, z0, weight, stride, padding):
    """Fast-path predicate: stride 1, float32, equal padding on both axes,
    at most 4096 tap rows (the JAX package's conditions). The JAX
    package's VMEM model of a canvas tile has no counterpart: the kernels
    tile the image, and they shrink their stages to fit shared memory, so
    no size of image, channel count or filter is refused beyond these."""
    from lasso_tpu_torch.conv2d.ops import _pair
    if _pair(stride) != (1, 1):
        return False
    if x.dtype != torch.float32 or z0.dtype != torch.float32:
        return False
    ph, pw = _pair(padding)
    if ph != pw:
        return False
    Cz, Cx, kh, kw = weight.shape
    return Cx * kh * _n_g8(kw) * 8 <= 4096


def _pad(padding):
    """The one padding of both axes, as an int."""
    p = tuple(padding) if isinstance(padding, (tuple, list)) \
        else (padding, padding)
    if len(p) != 2 or p[0] != p[1] or int(p[0]) < 0:
        raise ValueError(f"padding must be one non-negative int for both "
                         f"axes, got {padding!r}")
    return int(p[0])


def _conv_product(fn, a, w, padding, kernel_precision):
    """``fn(a, w)`` (a convolution) as the kernels compute it: bf16
    operands with FP32 sums, in ``'f32'`` the bf16x3 split ``fn(a_hi,
    w_hi) + fn(a_lo, w_hi) + fn(a_hi, w_lo)``; TF32 is off on the card."""
    if a.is_cuda:
        require_fp32_conv()
    if kernel_precision == "bf16":
        return fn(round_bf16(a), round_bf16(w), padding=padding)
    a_hi, a_lo = split_bf16(a)
    w_hi, w_lo = split_bf16(w)
    return (fn(a_hi, w_hi, padding=padding) + fn(a_lo, w_hi, padding=padding)
            + fn(a_hi, w_lo, padding=padding))


class ConvOperands(NamedTuple):
    """W's bf16 parts in the layouts the kernels read, made by
    :func:`conv_operands` once a call. P is 2 (hi, lo) for ``'f32'``, 1
    for ``'bf16'``; X16 is X rounded up to 16 and X256 to 256. Each is
    ``[P, kh, depth / 8, rows, 8]``: for every filter row ki, 8-deep
    chunks of the contraction, each chunk holding 16 bytes a row, the
    MMA's operand layout without swizzle.

    ``wa`` ``[P, kh, Cz16 / 8, (Cx kw)256, 8]``: K9a's B operand, row ``cx
    kw + kj``, depth ``cz``: ``W[cz, cx, ki, kj]``. ``wb`` ``[P, kh, (Cx
    kw)16 / 8, Cz256, 8]``: K9b's, row ``cz``, depth ``cx kw + kj``; where
    ``Cx kw < 16`` (:func:`_k9b_folds_rows`) K9b folds the filter rows
    into its contraction and ``wb`` is ``[P, 1, (Cx kh kw)16 / 8, Cz256,
    8]``, depth ``(cx kh + ki) kw + kj``: W as it lies. Zero past the real
    rows and depths.
    """
    wa: torch.Tensor
    wb: torch.Tensor


def _k9b_folds_rows(Cx, kw):
    """csrc/conv.cu's rule: K9b folds W's filter rows into its contraction
    where one row's ``Cx kw`` would fill less than a 16-deep MMA slice."""
    return Cx * kw < _SLICE


def _k9b_depth(Cx, kh, kw):
    """``(rows, depth)`` of K9b's operand: filter rows a B stage reads and
    the contraction a row, padded to whole slices."""
    if _k9b_folds_rows(Cx, kw):
        return 1, _up(Cx * kh * kw, _SLICE)
    return kh, _up(Cx * kw, _SLICE)


def _chunked(t, depth, rows):
    """``[P, kh, d, r]`` -> ``[P, kh, depth / 8, rows, 8]``, zero-padded to
    ``depth`` x ``rows``."""
    P, kh, d, r = t.shape
    t = torch.nn.functional.pad(t, (0, rows - r, 0, depth - d))
    return t.reshape(P, kh, depth // 8, 8, rows).transpose(3, 4).contiguous()


def conv_operands(weight, kernel_precision="f32"):
    """The :class:`ConvOperands` of ``weight`` [Cz, Cx, kh, kw]: W split
    (or rounded) once, as the TPU wrapper splits its tap matrices outside
    its kernel (fused_conv.py:484-495), in the kernels' layouts."""
    check_kernel_precision(kernel_precision)
    Cz, Cx, kh, kw = weight.shape
    parts = _bf16_parts(weight, kernel_precision)        # [P, Cz, Cx, kh, kw]
    P = parts.shape[0]
    a = parts.permute(0, 3, 1, 2, 4).reshape(P, kh, Cz, Cx * kw)
    rows, depth = _k9b_depth(Cx, kh, kw)
    b = (parts.permute(0, 3, 2, 4, 1) if rows == kh else
         parts.permute(0, 2, 3, 4, 1)).reshape(P, rows, -1, Cz)
    return ConvOperands(
        _chunked(a, _up(Cz, _SLICE), _up(Cx * kw, _NPAD)),
        _chunked(b, depth, _up(Cz, _NPAD)))


def _check_operands(ops, weight, kernel_precision):
    Cz, Cx, kh, kw = weight.shape
    P = 2 if kernel_precision == "f32" else 1
    rows, depth = _k9b_depth(Cx, kh, kw)
    _cuda.check_cuda(bfloat16=("wa", "wb"), wa=ops.wa, wb=ops.wb)
    _cuda.check_shapes({
        "operands.wa": (ops.wa, (P, kh, _up(Cz, _SLICE) // 8,
                                 _up(Cx * kw, _NPAD), 8)),
        "operands.wb": (ops.wb, (P, rows, depth // 8, _up(Cz, _NPAD), 8))})


def _momentum(z, z_prev, scal, t_vec):
    """``(y, t_next)``: the momentum point with the scalar momentum
    ``scal[2]``, or each sample's restart coefficient of the ``[N]`` carry
    ``t_vec`` (then also its t_next)."""
    if t_vec is None:
        return z + scal[2] * (z - z_prev), None
    c, t_next = _restart_coef(t_vec)
    return z + c.reshape(-1, 1, 1, 1) * (z - z_prev), t_next


def conv_decode_resid_plain(x, z, z_prev, weight, scal, t_vec=None,
                            padding=0, kernel_precision="f32"):
    """Plain version of K9a: ``conv_transpose2d(y, W, p) - x`` with ``y =
    z + c (z - z_prev)``."""
    y, _ = _momentum(z, z_prev, scal, t_vec)
    return _conv_product(F.conv_transpose2d, y, weight, _pad(padding),
                         kernel_precision) - x


def conv_adjoint_prox_plain(resid, z, z_prev, weight, scal, tcol=None,
                            t_vec=None, nonneg=False, padding=0,
                            kernel_precision="f32"):
    """Plain version of K9b. Returns ``(z_next, delta, t_new)``; ``t_new``
    is None without ``t_vec``."""
    lr, th = scal[0], scal[1]
    y, t_next = _momentum(z, z_prev, scal, t_vec)
    grad = _conv_product(F.conv2d, resid, weight, _pad(padding),
                         kernel_precision)
    prox = soft_threshold_nonneg if nonneg else soft_threshold
    z_next = prox(y - lr * grad,
                  th if tcol is None else tcol.reshape(1, -1, 1, 1))
    delta = torch.sum(torch.abs(z_next - z))
    t_new = None
    if t_vec is not None:
        rdot = torch.sum((y - z_next) * (z_next - z), dim=(1, 2, 3))
        t_new = torch.where(rdot > 0, 1.0, t_next)
    return z_next, delta, t_new


def _geometry(x, z, weight, padding):
    """``(N, Cz, Cx, Hz, Wz, kh, kw, p)`` after checking that x, z and W
    agree: W is [Cz, Cx, kh, kw], z [N, Cz, Hz, Wz] and x [N, Cx, Hz + kh
    - 1 - 2p, Wz + kw - 1 - 2p]."""
    p = _pad(padding)
    N, Cz, Hz, Wz = z.shape
    Cx, kh, kw = weight.shape[1], weight.shape[2], weight.shape[3]
    H, W = Hz + kh - 1 - 2 * p, Wz + kw - 1 - 2 * p
    if weight.shape[0] != Cz or tuple(x.shape) != (N, Cx, H, W) or H < 1 \
            or W < 1 or N == 0:
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, z "
                         f"{tuple(z.shape)}, weight {tuple(weight.shape)}, "
                         f"padding {p}")
    return N, Cz, Cx, Hz, Wz, kh, kw, p


def adjoint_scratch(N, Cz, Hz, Wz, device):
    """Scratch of K9b: the restart and delta partials of its blocks and the
    ``[N + 1]`` counters, zero; a launch leaves the counters zero, so one
    scratch serves every sub-step of a call. The partials hold ``N
    ceil(Cz / 64) Hz ceil(Wz / 8)`` floats each, a bound on the blocks of
    a launch (a block covers at least 64 code channels, one code row and 8
    columns)."""
    parts = N * -(-Cz // 64) * Hz * -(-Wz // 8)
    return (torch.empty((parts,), dtype=torch.float32, device=device),
            torch.empty((parts,), dtype=torch.float32, device=device),
            torch.zeros((N + 1,), dtype=torch.int32, device=device))


def _operands_for(weight, kernel_precision, operands):
    """``operands`` checked against W, or W's made now when None."""
    if operands is None:
        return conv_operands(weight, kernel_precision)
    _check_operands(operands, weight, kernel_precision)
    return operands


def conv_decode_resid(x, z, z_prev, weight, scal, t_vec=None, padding=0,
                      kernel_precision="f32", out=None, operands=None):
    """K9a: ``r = conv_transpose2d(y, W, p) - x`` with ``y = z + c (z -
    z_prev)``.

    ``scal`` is one ``[4]`` row of the scalar table; ``c`` is ``scal[2]``,
    or the restart coefficient of the ``[N]`` carry ``t_vec``. On a CPU
    tensor this runs :func:`conv_decode_resid_plain`; otherwise it launches
    the kernel into ``out`` (or a new tensor of x's shape) or raises.
    ``operands`` is :func:`conv_operands` of ``weight`` (made here when
    None).
    """
    check_kernel_precision(kernel_precision)
    if x.device.type == "cpu":
        return conv_decode_resid_plain(x, z, z_prev, weight, scal, t_vec,
                                       padding, kernel_precision)
    N, Cz, Cx, Hz, Wz, kh, kw, p = _geometry(x, z, weight, padding)
    if out is None:
        out = torch.empty_like(x)
    _cuda.check_cuda(x=x, z=z, z_prev=z_prev, weight=weight, scal=scal,
                     t_vec=t_vec, out=out)
    _cuda.check_shapes({"z_prev": (z_prev, (N, Cz, Hz, Wz)),
                        "scal": (scal, (4,)), "t_vec": (t_vec, (N,)),
                        "out": (out, tuple(x.shape))})
    ops = _operands_for(weight, kernel_precision, operands)
    CONV_DECODE_RESID[kernel_precision](
        x.data_ptr(), z.data_ptr(), z_prev.data_ptr(), ops.wa.data_ptr(),
        scal.data_ptr(), _cuda.ptr(t_vec), out.data_ptr(), N, Cz, Cx, Hz, Wz,
        kh, kw, p, _cuda.stream())
    return out


def conv_adjoint_prox(resid, z, z_prev, weight, scal, tcol=None, t_vec=None,
                      nonneg=False, padding=0, kernel_precision="f32",
                      out=None, with_delta=True, scratch=None,
                      operands=None):
    """K9b: ``z_next = prox(y - lr conv2d(resid, W, p), th)``.

    ``tcol`` is a ``[Cz]`` per-channel threshold (already times lr) in
    place of ``scal[1]``. With the ``[N]`` restart carry ``t_vec``,
    ``t_vec`` is advanced in place (``t = 1`` where the sample's ``<y -
    z_next, z_next - z> > 0``, else ``t_next``). ``out`` must not be ``z``
    or ``z_prev``. ``scratch`` is :func:`adjoint_scratch`'s and
    ``operands`` :func:`conv_operands`'s (each made here when None).
    Returns ``(z_next, delta)``, ``delta = sum|z_next - z|`` as a 0-d
    tensor (None when ``with_delta`` is False). On a CPU tensor this runs
    :func:`conv_adjoint_prox_plain`; otherwise it launches the kernel or
    raises.
    """
    check_kernel_precision(kernel_precision)
    if resid.device.type == "cpu":
        return _adjoint_plain_into(resid, z, z_prev, weight, scal, tcol,
                                   t_vec, nonneg, padding, kernel_precision,
                                   out, with_delta)
    N, Cz, Cx, Hz, Wz, kh, kw, p = _geometry(resid, z, weight, padding)
    dev = resid.device
    if out is None:
        out = torch.empty_like(z)
    if scratch is None:
        scratch = adjoint_scratch(N, Cz, Hz, Wz, dev)
    rpart, dpart, counters = scratch
    delta = (torch.empty((1,), dtype=torch.float32, device=dev)
             if with_delta else None)
    _cuda.check_cuda(int32=("counters",), resid=resid, z=z, z_prev=z_prev,
                     weight=weight, scal=scal, tcol=tcol, t_vec=t_vec,
                     rpart=rpart, dpart=dpart, counters=counters, out=out)
    _cuda.check_shapes({"z_prev": (z_prev, (N, Cz, Hz, Wz)),
                        "scal": (scal, (4,)), "tcol": (tcol, (Cz,)),
                        "t_vec": (t_vec, (N,)), "out": (out, tuple(z.shape)),
                        "counters": (counters, (N + 1,)),
                        "dpart": (dpart, tuple(rpart.shape))})
    if out.data_ptr() in (z.data_ptr(), z_prev.data_ptr()):
        raise ValueError("out must be another buffer than z and z_prev")
    ops = _operands_for(weight, kernel_precision, operands)
    CONV_ADJOINT_PROX[kernel_precision](
        resid.data_ptr(), z.data_ptr(), z_prev.data_ptr(), ops.wb.data_ptr(),
        scal.data_ptr(), _cuda.ptr(tcol), _cuda.ptr(t_vec), rpart.data_ptr(),
        dpart.data_ptr(), counters.data_ptr(), out.data_ptr(),
        _cuda.ptr(delta), N, Cz, Cx, Hz, Wz, kh, kw, p, int(nonneg),
        rpart.numel(), _cuda.stream())
    return out, (None if delta is None else delta.reshape(()))


def _adjoint_plain_into(resid, z, z_prev, weight, scal, tcol=None,
                        t_vec=None, nonneg=False, padding=0,
                        kernel_precision="f32", out=None, with_delta=True,
                        scratch=None, operands=None):
    """:func:`conv_adjoint_prox_plain` with the calling convention of
    :func:`conv_adjoint_prox` (``t_vec`` advanced in place, ``out``)."""
    z_next, delta, t_new = conv_adjoint_prox_plain(
        resid, z, z_prev, weight, scal, tcol, t_vec, nonneg, padding,
        kernel_precision)
    if t_vec is not None:
        t_vec.copy_(t_new)
    if out is not None:
        z_next = out.copy_(z_next)
    return z_next, (delta if with_delta else None)


def _decode_plain_into(x, z, z_prev, weight, scal, t_vec=None, padding=0,
                       kernel_precision="f32", out=None, operands=None):
    return conv_decode_resid_plain(x, z, z_prev, weight, scal, t_vec,
                                   padding, kernel_precision)


def _run_steps(decode_fn, adjoint_fn, x, z, z_prev, weight, lrs, threshs,
               moms, steps, padding, kernel_precision, t_vec, nonneg):
    """The sub-step loop of :func:`fused_conv_fista_multistep`, over a K9a
    and a K9b function (the kernels' wrappers, or their plain versions)."""
    check_kernel_precision(kernel_precision)
    th = _f32(threshs)
    has_col = th.ndim == 2
    scal = _scalar_table(lrs, 0.0 if has_col else th, moms, 0.0, steps,
                         x.device)
    tcol = (th.to(x.device).reshape(weight.shape[0]).contiguous()
            if has_col else None)
    t = (None if t_vec is None else
         t_vec.to(torch.float32, memory_format=torch.contiguous_format,
                  copy=True).reshape(x.shape[0]))
    scratch = (adjoint_scratch(x.shape[0], *z.shape[1:], x.device)
               if x.is_cuda else None)
    ops = conv_operands(weight, kernel_precision) if x.is_cuda else None
    # three rotating buffers: z_new never overwrites the z or z_prev that
    # the same launch reads
    bufs = [torch.empty_like(z) for _ in range(min(steps, 3))]
    r = None
    cur, prev = z, z_prev
    delta = None
    for s in range(steps):
        r = decode_fn(x, cur, prev, weight, scal[s], t, padding,
                      kernel_precision, out=r, operands=ops)
        z_new, delta = adjoint_fn(
            r, cur, prev, weight, scal[s], tcol, t, nonneg, padding,
            kernel_precision, out=bufs[s % 3], with_delta=s == steps - 1,
            scratch=scratch, operands=ops)
        cur, prev = z_new, cur
    if t_vec is not None:
        return cur, prev, t, delta
    return cur, prev, delta


def fused_conv_fista_multistep(x, z, z_prev, weight, lrs, threshs, moms,
                               steps, padding=0, kernel_precision="f32",
                               nonneg=False, t_vec=None):
    """``steps`` fused conv FISTA iterations in one call.

    x: [N, Cx, H, W], z and z_prev: [N, Cz, Hz, Wz], weight: [Cz, Cx, kh,
    kw] (PyTorch's conv_transpose layout), stride 1, ``padding`` on both
    axes. ``lrs``/``moms`` are scalars or length-``steps`` vectors
    (lagged-momentum convention of :mod:`lasso_tpu_torch.ops.fused_ista`);
    ``threshs`` is a scalar or length-``steps`` vector of alpha*lr, or a
    ``[Cz, 1]`` per-channel threshold column (already times lr) shared by
    every sub-step.

    ``t_vec`` (``[N]`` float32, carry convention t_{k-1}, init 0)
    switches on per-sample adaptive restart: ``moms`` is ignored and each
    sample advances its own t, reset when its gradient-mapping test ``<y -
    z_new, z_new - z> > 0`` fires.

    Returns ``(z_final, z_penultimate, delta)``, ``delta = sum|z_final -
    z_penultimate|`` of the last sub-step, with the updated t vector
    before ``delta`` when ``t_vec`` is given. The inputs are never
    written. The JAX package's ``shape_info``, ``block_n`` and
    ``interpret`` have no counterpart: the shapes carry the geometry, and
    the device of ``x`` picks the kernels or the plain versions.
    """
    if x.is_cuda:
        _cuda.WRAPPER_CALLS["fused_conv_fista_multistep"] += 1
    return _run_steps(conv_decode_resid, conv_adjoint_prox, x, z, z_prev,
                      weight, lrs, threshs, moms, steps, padding,
                      kernel_precision, t_vec, nonneg)


def fused_conv_fista_multistep_plain(x, z, z_prev, weight, lrs, threshs,
                                     moms, steps, padding=0,
                                     kernel_precision="f32", nonneg=False,
                                     t_vec=None):
    """The plain version of :func:`fused_conv_fista_multistep`, on any
    device."""
    return _run_steps(_decode_plain_into, _adjoint_plain_into, x, z, z_prev,
                      weight, lrs, threshs, moms, steps, padding,
                      kernel_precision, t_vec, nonneg)
