from lasso_tpu_torch.linalg.basic import cholesky_solve, lstsq, qr, ridge
from lasso_tpu_torch.linalg.spectral import lipschitz_constant, power_iteration

__all__ = ["qr", "lstsq", "ridge", "cholesky_solve", "power_iteration",
           "lipschitz_constant"]
