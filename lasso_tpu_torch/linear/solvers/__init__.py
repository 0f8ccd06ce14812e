from lasso_tpu_torch.linear.solvers.ista import ista

__all__ = ["ista"]
