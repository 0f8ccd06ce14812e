from lasso_tpu_torch.parallel.api import (data_parallel_encode,
                                          data_parallel_encode_conv2d,
                                          data_parallel_encode_nl,
                                          make_conv_train_step,
                                          make_online_train_step,
                                          make_task_driven_step,
                                          make_train_step)
from lasso_tpu_torch.parallel.distributed import (initialize,
                                                  make_global_mesh,
                                                  process_local_batch)
from lasso_tpu_torch.parallel.mesh import (code_sharding, data_sharding,
                                           make_mesh, replicated,
                                           weight_sharding)

__all__ = [
    "make_mesh", "data_sharding", "code_sharding", "weight_sharding",
    "replicated", "data_parallel_encode", "data_parallel_encode_conv2d",
    "data_parallel_encode_nl", "make_train_step",
    "make_conv_train_step", "make_online_train_step",
    "make_task_driven_step",
    "initialize", "make_global_mesh", "process_local_batch",
]
