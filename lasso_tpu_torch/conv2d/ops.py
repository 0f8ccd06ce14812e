"""Convolution primitives in PyTorch's layout.

Counterpart of the JAX package's ``conv2d/ops.py``. The conv sparse-coding
path needs an exact adjoint pair: the decoder is ``x_hat =
conv_transpose2d(z, W)`` and its adjoint is ``conv2d(., W)``. Both are
library convolutions (cuDNN on a CUDA tensor), as the JAX package leaves
them to XLA; the kernels of the fused path are in
:mod:`lasso_tpu_torch.ops.fused_conv`.

Layouts (PyTorch's):
    conv2d:            x [N, C_in, H, W],  kernel [C_out, C_in, kh, kw]
    conv_transpose2d:  z [N, C_in, H, W],  kernel [C_in, C_out, kh, kw]

``precision`` takes the names of :mod:`lasso_tpu_torch.config`:
'highest' is an FP32 convolution (TF32 off), 'high' the bf16x3 split
(three convolutions of the bf16 parts), 'default' both operands rounded
to bf16 with an FP32 sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lasso_tpu_torch.config import get_precision, require_fp32_conv
from lasso_tpu_torch.ops.common import matmul
from lasso_tpu_torch.ops.precision import round_bf16, split_bf16

_METHODS = ("auto", "gemm", "dilated")


def _pair(v):
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return tuple(v)
    return (v, v)


def _check_method(method):
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")


def _library_conv(fn, a, kernel, precision, **kw):
    """``fn(a, kernel, **kw)`` (a torch.nn.functional convolution) at a
    precision."""
    prec = get_precision(precision)
    if a.is_cuda:
        require_fp32_conv()
    if prec == "default":
        return fn(round_bf16(a), round_bf16(kernel), **kw)
    if prec == "high":
        a_hi, a_lo = split_bf16(a)
        k_hi, k_lo = split_bf16(kernel)
        return fn(a_hi, k_hi, **kw) + fn(a_hi, k_lo, **kw) \
            + fn(a_lo, k_hi, **kw)
    return fn(a, kernel, **kw)


def _conv2d_gemm(x, kernel, ph, pw, precision):
    """Stride-1 conv as static-shift im2col + one GEMM: ``[N*Ho*Wo,
    C_in*kh*kw] x [C_in*kh*kw, C_out]``. Same linear map."""
    N, Ci = x.shape[:2]
    Co, kh, kw = kernel.shape[0], kernel.shape[2], kernel.shape[3]
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    Ho, Wo = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    cols = torch.stack([x[:, :, ki:ki + Ho, kj:kj + Wo]
                        for ki in range(kh) for kj in range(kw)], dim=-1)
    k_mat = kernel.permute(1, 2, 3, 0).reshape(Ci * kh * kw, Co)
    cols = cols.permute(0, 2, 3, 1, 4).reshape(N * Ho * Wo, Ci * kh * kw)
    y = matmul(cols, k_mat, precision).reshape(N, Ho, Wo, Co)
    return y.permute(0, 3, 1, 2).contiguous()


def conv2d(x, kernel, stride=1, padding=0, precision=None, method="auto"):
    """``torch.nn.functional.conv2d`` at a precision.

    ``method``: 'gemm' forces the static-shift im2col + GEMM form (stride
    1 only); 'auto' and 'dilated' take the library convolution.
    """
    _check_method(method)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    if method == "gemm":
        if (sh, sw) != (1, 1):
            raise ValueError("method='gemm' requires stride 1")
        return _conv2d_gemm(x, kernel, ph, pw, precision)
    return _library_conv(F.conv2d, x, kernel, precision, stride=(sh, sw),
                         padding=(ph, pw))


def _code_shape(x_shape, weight_shape, stride=1, padding=0):
    """The shape of ``conv2d(x, weight)``, the codes of images ``x``, from
    the shapes alone."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    kh, kw = weight_shape[2], weight_shape[3]
    return (x_shape[0], weight_shape[0], (x_shape[2] + 2 * ph - kh) // sh + 1,
            (x_shape[3] + 2 * pw - kw) // sw + 1)


def _conv2d_weight(x, grad_out, weight_shape, stride=1, padding=0):
    """The gradient of ``<conv2d(x, V), grad_out>`` with respect to V: the
    adjoint of V -> ``conv2d(x, V)``, and so also of V ->
    ``conv_transpose2d(grad_out, V)`` (``<conv_transpose2d(z, V), x> =
    <z, conv2d(x, V)>``). One library convolution over the batch, at the
    global precision."""
    def fn(a, b, **kw):
        return torch.nn.grad.conv2d_weight(a, weight_shape, b, **kw)

    return _library_conv(fn, x, grad_out, None, stride=_pair(stride),
                         padding=_pair(padding))


def _conv_transpose2d_gemm(z, kernel, ph, pw, precision):
    """Stride-1 conv_transpose as one pointwise GEMM over C_in, ``[N*H*W,
    C_in] x [C_in, C_out*kh*kw]``, then the overlap-add of the kh*kw taps
    and the crop of the padding. Same linear map."""
    N, Ci, H, W = z.shape
    Co, kh, kw = kernel.shape[1], kernel.shape[2], kernel.shape[3]
    y = matmul(z.permute(0, 2, 3, 1).reshape(N * H * W, Ci),
               kernel.reshape(Ci, Co * kh * kw), precision)
    y = y.reshape(N, H, W, Co, kh, kw)
    out = torch.zeros((N, Co, H + kh - 1, W + kw - 1), dtype=y.dtype,
                      device=y.device)
    for ki in range(kh):
        for kj in range(kw):
            out[:, :, ki:ki + H, kj:kj + W] += \
                y[:, :, :, :, ki, kj].permute(0, 3, 1, 2)
    return out[:, :, ph:out.shape[2] - ph, pw:out.shape[3] - pw].contiguous()


def conv_transpose2d(z, kernel, stride=1, padding=0, precision=None,
                     method="auto"):
    """``torch.nn.functional.conv_transpose2d`` at a precision: the exact
    adjoint of :func:`conv2d` with the same kernel, stride and padding.

    ``method``: 'gemm' forces the GEMM + overlap-add form (stride 1 only);
    'auto' and 'dilated' take the library transpose convolution. (The JAX
    package's 'auto' picks the fold form for few output channels, where
    the TPU's convolution degenerates to a skinny GEMM; cuDNN has no such
    cliff.)
    """
    _check_method(method)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    if method == "gemm":
        if (sh, sw) != (1, 1):
            raise ValueError("method='gemm' requires stride 1")
        return _conv_transpose2d_gemm(z, kernel, ph, pw, precision)
    return _library_conv(F.conv_transpose2d, z, kernel, precision,
                         stride=(sh, sw), padding=(ph, pw))
