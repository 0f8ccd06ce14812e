"""Lipschitz constants of convolutional operators.

Counterpart of the JAX package's ``conv2d/lip_const.py``:

* :func:`lip_constant`: the top eigenvalue of the conv normal operator, by
  power iteration (:func:`lasso_tpu_torch.linalg.power_iteration`) over
  the operator on the device of the kernel.
* :func:`lip_bound_conv2d` / :class:`LipBoundConv2d`: the Araujo et al.
  (2020) trigonometric-polynomial upper bound, plain matmul arithmetic;
  the class keeps the frequency buffer between calls.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.conv2d.ops import conv2d, conv_transpose2d
from lasso_tpu_torch.linalg.spectral import power_iteration
from lasso_tpu_torch.ops.common import matmul


def lip_constant(kernel, imsize, transpose=False, sqrt=False, stride=1,
                 padding=0, maxiter=500, tol=1e-9, v0=None, generator=None):
    """Top eigenvalue of the conv normal operator.

    kernel: [C_z, C_x, kh, kw] (the conv_transpose layout when
    ``transpose=True``, the conv layout otherwise). The start vector, of
    shape ``[1, C, *imsize]``, is ``v0`` when given, else a standard
    normal draw from ``generator`` (seed 0 when that is None too) on the
    kernel's device. The JAX package draws it from ``PRNGKey(0)``, whose
    bits torch cannot reproduce: pass that draw as ``v0`` for a
    like-for-like comparison.
    """
    out_channels, in_channels = kernel.shape[:2]
    channels = out_channels if transpose else in_channels
    shape = (1, channels) + tuple(imsize)
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=kernel.device).manual_seed(0)
        v0 = torch.randn(shape, generator=generator, dtype=kernel.dtype,
                         device=kernel.device)
    else:
        v0 = torch.as_tensor(v0, dtype=kernel.dtype,
                             device=kernel.device).reshape(shape)

    def matvec(v):
        v = v.reshape(shape)
        if transpose:
            u = conv_transpose2d(v, kernel, stride=stride, padding=padding)
            return conv2d(u, kernel, stride=stride,
                          padding=padding).reshape(-1)
        u = conv2d(v, kernel, stride=stride, padding=padding)
        return conv_transpose2d(u, kernel, stride=stride,
                                padding=padding).reshape(-1)

    lam, _ = power_iteration(matvec, v0.reshape(-1), maxiter=maxiter,
                             tol=tol)
    return torch.sqrt(lam) if sqrt else lam


def _freq_buffer(ksize, padding, sample, dtype=torch.float32):
    """Frequency-location phase buffer ``[K^2, S^2]``."""
    xs = torch.linspace(0.0, 2 * math.pi, sample, dtype=dtype)
    w0, w1 = torch.meshgrid(xs, xs, indexing="ij")
    w0, w1 = w0.reshape(-1, 1), w1.reshape(-1, 1)
    p_index = 1.0 + torch.arange(padding - ksize, padding, dtype=dtype)
    H0, H1 = torch.meshgrid(p_index, p_index, indexing="ij")
    H0, H1 = H0.reshape(1, -1), H1.reshape(1, -1)
    return (w0 * H0 + w1 * H1).T


def _lip_bound(kernel, buf, sqrt, prec):
    if kernel.shape[0] > kernel.shape[1]:
        kernel = kernel.transpose(0, 1)
    k = kernel.reshape(kernel.shape[0], kernel.shape[1], -1)  # [Co, Ci, K^2]
    poly_real = matmul(k, torch.cos(buf), prec)               # [Co, Ci, S^2]
    poly_imag = matmul(k, torch.sin(buf), prec)
    poly = (torch.sum(torch.square(poly_real), dim=1)
            + torch.sum(torch.square(poly_imag), dim=1))      # [Co, S^2]
    bound = torch.sum(torch.max(poly, dim=-1).values)
    return torch.sqrt(bound) if sqrt else bound


def _check_kernel_size(shape, stride):
    if shape[-1] != shape[-2]:
        raise ValueError("The last 2 dim of the kernel must be equal.")
    if shape[-1] % 2 != 1:
        raise ValueError("The dimension of the kernel must be odd.")
    if stride != 1:
        raise NotImplementedError("LipBound not implemented for stride > 1.")


def lip_bound_conv2d(kernel, padding, stride=1, sample=50, sqrt=False,
                     precision=None):
    """Araujo Toeplitz bound on the top eigenvalue of ``W^T W`` for a conv
    operator: square odd kernels, stride 1."""
    assert kernel.ndim == 4
    _check_kernel_size(kernel.shape, stride)
    buf = _freq_buffer(kernel.shape[-1], padding, sample,
                       kernel.dtype).to(kernel.device)
    return _lip_bound(kernel, buf, sqrt, get_precision(precision))


class LipBoundConv2d:
    """Callable keeping the frequency buffer of :func:`lip_bound_conv2d`
    across evaluations."""

    def __init__(self, kernel_size, padding, stride=1, sample=50,
                 sqrt=False):
        assert len(kernel_size) == 4
        _check_kernel_size(kernel_size, stride)
        self.ksize = kernel_size[-1]
        self.sqrt = sqrt
        self.buf = _freq_buffer(self.ksize, padding, sample)

    def __call__(self, kernel, precision=None):
        assert kernel.ndim == 4
        assert kernel.shape[2] == kernel.shape[3] == self.ksize
        return _lip_bound(kernel, self.buf.to(device=kernel.device,
                                            dtype=kernel.dtype),
                          self.sqrt, get_precision(precision))
