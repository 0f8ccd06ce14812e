"""Convolutional dictionary learning: the objective.

Counterpart of the JAX package's ``conv2d/dict_learning.py``. Only
:func:`conv_lasso_loss` is ported; ``update_kernel``,
``update_kernel_constrained`` and ``conv_dict_learning`` need the conjugate
gradient solver and are not ported yet (ROADMAP A item 11).
"""

from __future__ import annotations

import torch

from lasso_tpu_torch.conv2d.ops import conv_transpose2d


def conv_lasso_loss(X, Z, weight, alpha=1.0, stride=1, padding=0):
    """Per-sample-mean conv lasso objective (the conv analogue of
    :func:`lasso_tpu_torch.linear.lasso_loss`)."""
    X_hat = conv_transpose2d(Z, weight, stride=stride, padding=padding)
    loss = (0.5 * torch.sum(torch.square(X - X_hat))
            + torch.sum(alpha * torch.abs(Z)))
    return loss / X.shape[0]
