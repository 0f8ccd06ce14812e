from lasso_tpu_torch.linear.solvers.coordinate_descent import (
    coord_descent, coord_descent_mod)
from lasso_tpu_torch.linear.solvers.group_lasso import (group_ista,
                                                        group_lasso_objective,
                                                        group_soft_threshold,
                                                        resolve_groups)
from lasso_tpu_torch.linear.solvers.ista import ista
from lasso_tpu_torch.linear.solvers.omp import orthogonal_matching_pursuit

__all__ = ["ista", "coord_descent", "coord_descent_mod", "group_ista",
           "group_lasso_objective", "group_soft_threshold", "resolve_groups",
           "orthogonal_matching_pursuit"]
