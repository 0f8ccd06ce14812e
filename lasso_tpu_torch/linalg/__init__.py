from lasso_tpu_torch.linalg.basic import (batch_cholesky_solve,
                                          cholesky_inverse, cholesky_solve,
                                          lstsq, qr, ridge)
from lasso_tpu_torch.linalg.conjgrad import (STATUS_MESSAGES, batch_cg,
                                             batch_cg_conv2d, cg, conjgrad,
                                             conjgrad_per_row)
from lasso_tpu_torch.linalg.line_search import (backtracking_armijo,
                                                golden_section)
from lasso_tpu_torch.linalg.spectral import lipschitz_constant, power_iteration

__all__ = ["qr", "lstsq", "ridge", "cholesky_solve", "batch_cholesky_solve",
           "cholesky_inverse", "conjgrad", "conjgrad_per_row", "cg",
           "batch_cg", "batch_cg_conv2d", "STATUS_MESSAGES", "golden_section",
           "backtracking_armijo", "power_iteration", "lipschitz_constant"]
