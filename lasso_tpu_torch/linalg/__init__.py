from lasso_tpu_torch.linalg.basic import (batch_cholesky_solve,
                                          cholesky_inverse, cholesky_solve,
                                          lstsq, qr, ridge)
from lasso_tpu_torch.linalg.spectral import lipschitz_constant, power_iteration

__all__ = ["qr", "lstsq", "ridge", "cholesky_solve", "batch_cholesky_solve",
           "cholesky_inverse", "power_iteration", "lipschitz_constant"]
