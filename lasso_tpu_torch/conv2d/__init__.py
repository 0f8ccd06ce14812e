from lasso_tpu_torch.conv2d.dict_learning import (conv_dict_learning,
                                                  conv_lasso_loss,
                                                  update_kernel,
                                                  update_kernel_constrained)
from lasso_tpu_torch.conv2d.implicit import (implicit_conv_encode,
                                             make_implicit_conv_encoder)
from lasso_tpu_torch.conv2d.ista import ista_conv2d
from lasso_tpu_torch.conv2d.lip_const import (LipBoundConv2d,
                                              lip_bound_conv2d, lip_constant)
from lasso_tpu_torch.conv2d.ops import conv2d, conv_transpose2d

__all__ = ["conv2d", "conv_transpose2d", "conv_dict_learning",
           "conv_lasso_loss", "implicit_conv_encode", "ista_conv2d",
           "lip_constant", "lip_bound_conv2d", "LipBoundConv2d",
           "make_implicit_conv_encoder", "update_kernel",
           "update_kernel_constrained"]
