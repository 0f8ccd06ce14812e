from lasso_tpu_torch.conv2d.dict_learning import conv_lasso_loss
from lasso_tpu_torch.conv2d.ista import ista_conv2d
from lasso_tpu_torch.conv2d.lip_const import (LipBoundConv2d,
                                              lip_bound_conv2d, lip_constant)
from lasso_tpu_torch.conv2d.ops import conv2d, conv_transpose2d

__all__ = ["conv2d", "conv_transpose2d", "conv_lasso_loss", "ista_conv2d",
           "lip_constant", "lip_bound_conv2d", "LipBoundConv2d"]
