from lasso_tpu_torch.ops.common import matmul
from lasso_tpu_torch.ops.shrink import soft_threshold, softshrink

__all__ = ["matmul", "soft_threshold", "softshrink"]
