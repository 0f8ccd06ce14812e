from lasso_tpu_torch.linear.solvers.constrained import constrained_inference
from lasso_tpu_torch.linear.solvers.coordinate_descent import (
    coord_descent, coord_descent_mod)
from lasso_tpu_torch.linear.solvers.gpsr import gpsr_basic
from lasso_tpu_torch.linear.solvers.group_lasso import (group_ista,
                                                        group_lasso_objective,
                                                        group_soft_threshold,
                                                        resolve_groups)
from lasso_tpu_torch.linear.solvers.interior_point import interior_point
from lasso_tpu_torch.linear.solvers.ista import ista
from lasso_tpu_torch.linear.solvers.iterative_ridge import iterative_ridge
from lasso_tpu_torch.linear.solvers.omp import orthogonal_matching_pursuit
from lasso_tpu_torch.linear.solvers.orthant_wise_newton import (
    orthant_wise_newton)
from lasso_tpu_torch.linear.solvers.split_bregman import split_bregman

__all__ = ["constrained_inference", "coord_descent", "coord_descent_mod",
           "gpsr_basic", "group_ista", "group_lasso_objective",
           "group_soft_threshold", "interior_point", "ista",
           "iterative_ridge", "orthant_wise_newton",
           "orthogonal_matching_pursuit", "resolve_groups", "split_bregman"]
