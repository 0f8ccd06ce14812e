"""The shared linear-algebra helpers under the name ``linear.utils``, as
the JAX package exposes them; they live in :mod:`lasso_tpu_torch.linalg`."""

from lasso_tpu_torch.linalg.basic import (batch_cholesky_solve,
                                          cholesky_inverse, lstsq, qr, ridge)

__all__ = ["qr", "lstsq", "ridge", "batch_cholesky_solve", "cholesky_inverse"]
