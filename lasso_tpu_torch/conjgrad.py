"""Top-level conjugate-gradient module, the twin of the JAX package's
top-level ``conjgrad`` (``batch_cg_conv2d`` is not ported yet: ROADMAP A
item 11)."""

from lasso_tpu_torch.linalg.conjgrad import (STATUS_MESSAGES, batch_cg, cg,
                                             conjgrad)

__all__ = ["conjgrad", "cg", "batch_cg", "STATUS_MESSAGES"]
