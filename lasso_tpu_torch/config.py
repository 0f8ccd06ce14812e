"""Global numeric configuration for lasso_tpu_torch.

Counterpart of the JAX package's ``config.py``. A matmul precision is one of
three names:

* ``'highest'`` (aliases ``'float32'``): true FP32 products. On a CUDA
  tensor this needs ``torch.backends.cuda.matmul.allow_tf32 = False``,
  which :func:`require_fp32_matmul` sets and checks: single-pass TF32
  keeps about three decimal digits, which breaks the solvers' f32
  parity. This is the library default, as ``lax.Precision.HIGHEST`` is
  in the JAX package.
* ``'high'``: a bf16x3 split product (hi*hi + hi*lo + lo*hi, f32
  accumulate), as ``lax.Precision.HIGH``.
* ``'default'`` (alias ``'bfloat16'``): operands rounded to bf16, f32
  accumulate, as ``lax.Precision.DEFAULT`` on the TPU's matrix unit.

The same names hold for convolutions. cuDNN runs a float32 convolution in
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False, and that flag is
True by default (unlike the matmul flag), so every f32 convolution on a
CUDA tensor calls :func:`require_fp32_conv` first.
"""

from __future__ import annotations

import contextlib

import torch

_PRECISION_NAMES = {
    "default": "default",
    "bfloat16": "default",
    "float32": "highest",
    "high": "high",
    "highest": "highest",
}

_default_precision = "highest"


def _parse_precision(p):
    if p is None:
        return _default_precision
    if isinstance(p, str):
        try:
            return _PRECISION_NAMES[p.lower()]
        except KeyError:
            raise ValueError(
                f"unknown precision {p!r}; expected one of "
                f"{sorted(_PRECISION_NAMES)}") from None
    raise TypeError(f"cannot interpret {p!r} as a matmul precision")


def get_precision(override=None) -> str:
    """Resolve an optional per-call precision override to one of
    ``'highest'``, ``'high'`` or ``'default'``."""
    return _parse_precision(override)


@contextlib.contextmanager
def matmul_precision(p):
    """Context manager setting the library-wide default matmul precision
    for calls made inside it."""
    global _default_precision
    old = _default_precision
    _default_precision = _parse_precision(p)
    try:
        yield
    finally:
        _default_precision = old


def require_fp32_matmul():
    """Turn TF32 off for CUDA matmuls and check that it is off: the
    f32 paths promise f32-grade products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32


def require_fp32_conv():
    """Turn TF32 off for cuDNN convolutions and check that it is off: the
    f32 conv paths promise f32-grade sums, and cuDNN's default is TF32."""
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cudnn.allow_tf32
