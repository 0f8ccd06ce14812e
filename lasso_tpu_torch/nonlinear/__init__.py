from lasso_tpu_torch.nonlinear.implicit import make_implicit_nl_encoder
from lasso_tpu_torch.nonlinear.ista import hessian_2norm, ista_nl, softshrink
from lasso_tpu_torch.nonlinear.iterative_ridge_bfgs import iterative_ridge_bfgs
from lasso_tpu_torch.nonlinear.owlqn import owlqn
from lasso_tpu_torch.nonlinear.split_bregman import split_bregman_nl

__all__ = ["ista_nl", "hessian_2norm", "make_implicit_nl_encoder",
           "softshrink", "owlqn", "iterative_ridge_bfgs",
           "split_bregman_nl"]
