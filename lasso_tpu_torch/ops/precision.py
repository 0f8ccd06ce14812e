"""bf16 rounding and split-float helpers.

Counterpart of the JAX package's ``ops/precision.py``. The JAX package needs
two split variants because XLA may elide an f32->bf16->f32 cast chain
(``split_bf16_xla`` uses ``lax.reduce_precision`` instead). PyTorch
performs every cast it is given, so one variant of each helper is
enough here and ``split_bf16_xla`` has no counterpart.
"""

from __future__ import annotations

import torch


def round_bf16(a):
    """Round f32 values onto the bf16 grid (round to nearest even),
    keeping the f32 dtype."""
    return a.to(torch.bfloat16).to(a.dtype)


def split_bf16(a):
    """Split f32 into a bf16-grid high part and a bf16-grid residual,
    both returned as f32: ``a ~= hi + lo`` to about 2^-16 relative."""
    hi = round_bf16(a)
    lo = round_bf16(a - hi)
    return hi, lo


def check_kernel_precision(kernel_precision):
    """The kernels' two precisions: ``'f32'`` and ``'bf16'``."""
    if kernel_precision not in ("f32", "bf16"):
        raise ValueError(f"kernel_precision must be 'f32' or 'bf16', got "
                         f"{kernel_precision!r}")
