from lasso_tpu_torch.utils.chunked import chunked_encode
from lasso_tpu_torch.utils.convert import (from_numpy_params, from_numpy_tree,
                                          resolve_device)

__all__ = ["chunked_encode", "from_numpy_params", "from_numpy_tree",
           "resolve_device"]
