from lasso_tpu_torch.linear.solvers.coordinate_descent import (
    coord_descent, coord_descent_mod)
from lasso_tpu_torch.linear.solvers.ista import ista

__all__ = ["ista", "coord_descent", "coord_descent_mod"]
