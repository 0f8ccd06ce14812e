"""Top-level conjugate-gradient module, the twin of the JAX package's
top-level ``conjgrad``: the names of :mod:`lasso_tpu_torch.linalg.conjgrad`
that the JAX package exports there."""

from lasso_tpu_torch.linalg.conjgrad import (STATUS_MESSAGES, batch_cg,
                                             batch_cg_conv2d, cg, conjgrad)

__all__ = ["conjgrad", "cg", "batch_cg", "batch_cg_conv2d", "STATUS_MESSAGES"]
