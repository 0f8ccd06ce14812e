"""lasso_tpu_torch: the PyTorch and CUDA port of the JAX package.

A second package beside the JAX package, with the same module paths,
public names, arguments and return conventions. It imports ``torch``
and never ``jax`` or anything of the JAX package. Plain tensor code is
PyTorch; every TPU kernel on a ported path is a hand-written CUDA kernel
for Hopper under ``csrc/``, built by ``nvcc`` at its first use. Tensor
functions run on the device of their inputs; the command line and the
bench take ``--device`` (default ``cuda``).
"""

from lasso_tpu_torch import (config, conv2d, linalg, linear, nonlinear, ops,
                             parallel, utils)
from lasso_tpu_torch.linear import (dict_evaluate, dict_learning,
                                    initialize_code, lasso_loss, sparse_encode,
                                    update_dict, update_dict_block,
                                    update_dict_ridge)

__version__ = "0.1.0"

__all__ = ["config", "conv2d", "linalg", "linear", "nonlinear", "ops",
           "parallel", "utils",
           "sparse_encode",
           "initialize_code", "dict_learning", "dict_evaluate", "lasso_loss",
           "update_dict", "update_dict_block", "update_dict_ridge"]
