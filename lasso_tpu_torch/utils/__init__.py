from lasso_tpu_torch.utils.checkpoint import (dict_learning_resumable,
                                              latest_step, restore_checkpoint,
                                              save_checkpoint)
from lasso_tpu_torch.utils.chunked import chunked_encode
from lasso_tpu_torch.utils.configs import CONFIGS, SolverConfig, config_for
from lasso_tpu_torch.utils.convert import (from_numpy_params, from_numpy_tree,
                                          resolve_device)
from lasso_tpu_torch.utils.export import export_encoder, load_encoder
from lasso_tpu_torch.utils.profiling import (capture_trace, debug_nans,
                                             time_solver, trace)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "dict_learning_resumable", "SolverConfig", "CONFIGS", "config_for",
    "trace", "capture_trace", "time_solver", "debug_nans",
    "export_encoder", "load_encoder", "chunked_encode",
    "from_numpy_params", "from_numpy_tree", "resolve_device",
]
