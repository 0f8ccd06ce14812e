"""Soft-thresholding (shrinkage) operators.

Counterpart of the JAX package's ``ops/shrink.py``: the proximal step of the
l1 penalty, elementwise.
"""

from __future__ import annotations

import torch


def soft_threshold(x, theta):
    """prox of ``theta * ||.||_1``: sign(x) * max(|x| - theta, 0).

    ``theta`` may be a scalar or any shape broadcastable against ``x``.
    """
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - theta, 0.0)


def soft_threshold_nonneg(x, theta):
    """prox of ``theta * ||.||_1 + i_{>=0}``: max(x - theta, 0).

    The one-sided shrink of the non-negative lasso.
    """
    return torch.clamp_min(x - theta, 0.0)


# Alias matching the torch naming used by the reference.
softshrink = soft_threshold
