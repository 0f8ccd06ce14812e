from lasso_tpu_torch.ops.common import l1_norm, matmul, sq_norm
from lasso_tpu_torch.ops.shrink import soft_threshold, softshrink

__all__ = ["matmul", "l1_norm", "sq_norm", "soft_threshold", "softshrink"]
