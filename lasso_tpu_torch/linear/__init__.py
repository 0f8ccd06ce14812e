from lasso_tpu_torch.linear import solvers
from lasso_tpu_torch.linear.dict_learning import (dict_evaluate, dict_learning,
                                                  dict_learning_online,
                                                  lasso_loss, update_dict,
                                                  update_dict_block,
                                                  update_dict_online,
                                                  update_dict_ridge)
from lasso_tpu_torch.linear.implicit import (implicit_sparse_encode,
                                             make_implicit_encoder,
                                             make_implicit_group_encoder)
from lasso_tpu_torch.linear.path import lasso_path
from lasso_tpu_torch.linear.screening import screen_atoms, screened_encode
from lasso_tpu_torch.linear.sparse_encode import initialize_code, sparse_encode

__all__ = ["sparse_encode", "initialize_code", "implicit_sparse_encode",
           "make_implicit_encoder", "make_implicit_group_encoder", "solvers",
           "lasso_loss", "dict_evaluate", "update_dict", "update_dict_block",
           "update_dict_ridge", "dict_learning", "update_dict_online",
           "dict_learning_online", "lasso_path", "screen_atoms",
           "screened_encode"]
