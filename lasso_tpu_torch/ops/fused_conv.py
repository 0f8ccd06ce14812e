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
restart test in its epilogue). :func:`fused_conv_fista_multistep` issues
them, one pair per sub-step, on the current stream, and reads each
sub-step's scalars from a device ``[S, 4]`` table by index, with no host
sync between sub-steps.

On a CPU tensor the same functions run the plain PyTorch versions
(:func:`conv_decode_resid_plain`, :func:`conv_adjoint_prox_plain`), which
repeat the kernels' arithmetic, bf16 rounding included; a CUDA tensor
always takes the kernel, and a tensor on any other device raises.

The TPU kernel works on a "canvas" layout built for the TPU's lanes
(``canvas_dims``, ``pack_*``, ``unpack_codes``, ``_k_mats`` in the JAX
package); the port works on ``[N, C, H, W]`` as it lies and has no
counterpart of them.

``kernel_precision``: ``'f32'`` is FP32 (FMA in the kernels, TF32 off in
the plain versions' cuDNN convolutions; the TPU kernel splits into bf16 hi
+ lo), ``'bf16'`` rounds y, the residual and W to bf16 and sums in FP32,
the semantics of the TPU kernel's native bf16 passes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lasso_tpu_torch.config import require_fp32_conv
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.fused_ista import (_f32, _restart_coef,
                                            _scalar_table)
from lasso_tpu_torch.ops.precision import check_kernel_precision, round_bf16
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

# csrc/conv.cu's blocking: 32x32 outputs a block, 8 code channels a K9b
# block (4 or 1 image channels a K9a block), patches of up to 4 channels
# staged at a time, in 48 KB where they fit and at most 227 KB
_TILE, _CZT, _CHUNK = 32, 8, 4
_SMEM_STATIC, _SMEM_MAX = 48 * 1024, 232448


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


def _smem_bytes(chunk, ct, kh, kw):
    return 4 * (chunk * (_TILE + kh - 1) * ((_TILE + kw - 1) | 1)
                + chunk * ct * kh * kw)


def _fits_a_block(channels, ct, kh, kw):
    """``pick_chunk`` of csrc/conv.cu: does one stage of at least one
    channel fit the card's shared memory?"""
    chunk = min(channels, _CHUNK)
    while chunk > 1 and _smem_bytes(chunk, ct, kh, kw) > _SMEM_STATIC:
        chunk //= 2
    return _smem_bytes(chunk, ct, kh, kw) <= _SMEM_MAX


def supports_fused_conv(x, z0, weight, stride, padding):
    """Fast-path predicate: stride 1, float32, equal padding on both axes,
    at most 4096 tap rows (the JAX package's conditions), and a block of
    each kernel within the card's shared memory. The JAX package's VMEM
    model of a canvas tile has no counterpart: the kernels tile the image,
    so the size of the image and the number of channels do not enter."""
    from lasso_tpu_torch.conv2d.ops import _pair
    if _pair(stride) != (1, 1):
        return False
    if x.dtype != torch.float32 or z0.dtype != torch.float32:
        return False
    ph, pw = _pair(padding)
    if ph != pw:
        return False
    Cz, Cx, kh, kw = weight.shape
    if Cx * kh * _n_g8(kw) * 8 > 4096:
        return False
    return (_fits_a_block(Cz, 4 if Cx >= 4 else 1, kh, kw)
            and _fits_a_block(Cx, _CZT, kh, kw))


def _pad(padding):
    """The one padding of both axes, as an int."""
    p = tuple(padding) if isinstance(padding, (tuple, list)) \
        else (padding, padding)
    if len(p) != 2 or p[0] != p[1] or int(p[0]) < 0:
        raise ValueError(f"padding must be one non-negative int for both "
                         f"axes, got {padding!r}")
    return int(p[0])


def _conv_f32(fn, a, w, padding):
    if a.is_cuda:
        require_fp32_conv()
    return fn(a, w, padding=padding)


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
    w = weight
    if kernel_precision == "bf16":
        y, w = round_bf16(y), round_bf16(w)
    return _conv_f32(F.conv_transpose2d, y, w, _pad(padding)) - x


def conv_adjoint_prox_plain(resid, z, z_prev, weight, scal, tcol=None,
                            t_vec=None, nonneg=False, padding=0,
                            kernel_precision="f32"):
    """Plain version of K9b. Returns ``(z_next, delta, t_new)``; ``t_new``
    is None without ``t_vec``."""
    lr, th = scal[0], scal[1]
    y, t_next = _momentum(z, z_prev, scal, t_vec)
    r, w = resid, weight
    if kernel_precision == "bf16":
        r, w = round_bf16(r), round_bf16(w)
    grad = _conv_f32(F.conv2d, r, w, _pad(padding))
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
    """Scratch of K9b: the restart and delta partials of its blocks
    (``[N * blocks a sample]`` floats each) and the ``[N + 1]`` counters,
    zero; a launch leaves the counters zero, so one scratch serves every
    sub-step of a call."""
    parts = (N * -(-Cz // _CZT) * -(-Hz // _TILE) * -(-Wz // _TILE))
    return (torch.empty((parts,), dtype=torch.float32, device=device),
            torch.empty((parts,), dtype=torch.float32, device=device),
            torch.zeros((N + 1,), dtype=torch.int32, device=device))


def conv_decode_resid(x, z, z_prev, weight, scal, t_vec=None, padding=0,
                      kernel_precision="f32", out=None):
    """K9a: ``r = conv_transpose2d(y, W, p) - x`` with ``y = z + c (z -
    z_prev)``.

    ``scal`` is one ``[4]`` row of the scalar table; ``c`` is ``scal[2]``,
    or the restart coefficient of the ``[N]`` carry ``t_vec``. On a CPU
    tensor this runs :func:`conv_decode_resid_plain`; otherwise it launches
    the kernel into ``out`` (or a new tensor of x's shape) or raises.
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
    CONV_DECODE_RESID[kernel_precision](
        x.data_ptr(), z.data_ptr(), z_prev.data_ptr(), weight.data_ptr(),
        scal.data_ptr(), _cuda.ptr(t_vec), out.data_ptr(), N, Cz, Cx, Hz, Wz,
        kh, kw, p, _cuda.stream())
    return out


def conv_adjoint_prox(resid, z, z_prev, weight, scal, tcol=None, t_vec=None,
                      nonneg=False, padding=0, kernel_precision="f32",
                      out=None, with_delta=True, scratch=None):
    """K9b: ``z_next = prox(y - lr conv2d(resid, W, p), th)``.

    ``tcol`` is a ``[Cz]`` per-channel threshold (already times lr) in
    place of ``scal[1]``. With the ``[N]`` restart carry ``t_vec``,
    ``t_vec`` is advanced in place (``t = 1`` where the sample's ``<y -
    z_next, z_next - z> > 0``, else ``t_next``). ``out`` must not be ``z``
    or ``z_prev``. ``scratch`` is :func:`adjoint_scratch`'s (made here when
    None). Returns ``(z_next, delta)``, ``delta = sum|z_next - z|`` as a
    0-d tensor (None when ``with_delta`` is False). On a CPU tensor this
    runs :func:`conv_adjoint_prox_plain`; otherwise it launches the kernel
    or raises.
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
    CONV_ADJOINT_PROX[kernel_precision](
        resid.data_ptr(), z.data_ptr(), z_prev.data_ptr(), weight.data_ptr(),
        scal.data_ptr(), _cuda.ptr(tcol), _cuda.ptr(t_vec), rpart.data_ptr(),
        dpart.data_ptr(), counters.data_ptr(), out.data_ptr(),
        _cuda.ptr(delta), N, Cz, Cx, Hz, Wz, kh, kw, p, int(nonneg),
        rpart.numel(), _cuda.stream())
    return out, (None if delta is None else delta.reshape(()))


def _adjoint_plain_into(resid, z, z_prev, weight, scal, tcol=None,
                        t_vec=None, nonneg=False, padding=0,
                        kernel_precision="f32", out=None, with_delta=True,
                        scratch=None):
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
                       kernel_precision="f32", out=None):
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
    # three rotating buffers: z_new never overwrites the z or z_prev that
    # the same launch reads
    bufs = [torch.empty_like(z) for _ in range(min(steps, 3))]
    r = None
    cur, prev = z, z_prev
    delta = None
    for s in range(steps):
        r = decode_fn(x, cur, prev, weight, scal[s], t, padding,
                      kernel_precision, out=r)
        z_new, delta = adjoint_fn(
            r, cur, prev, weight, scal[s], tcol, t, nonneg, padding,
            kernel_precision, out=bufs[s % 3], with_delta=s == steps - 1,
            scratch=scratch)
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
