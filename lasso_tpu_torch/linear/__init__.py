from lasso_tpu_torch.linear import solvers
from lasso_tpu_torch.linear.sparse_encode import initialize_code, sparse_encode

__all__ = ["sparse_encode", "initialize_code", "solvers"]
