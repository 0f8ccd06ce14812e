"""Multi-process initialization and mesh construction.

Counterpart of the JAX package's ``parallel/distributed.py`` on
``torch.distributed``: one process per device. Call :func:`initialize`
once in each process, then build the mesh over all of them with
:func:`make_global_mesh`; under a launcher such as ``torchrun
--nproc-per-node=G`` the arguments come from its environment.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, **kwargs):
    """Initialize the default process group (a no-op for one process).

    ``coordinator_address`` ('host:port') becomes the ``tcp://``
    rendezvous; ``init_method`` or ``store`` in ``kwargs`` (they go to
    ``torch.distributed.init_process_group``) take its place. With none of
    them and no ``num_processes``, a launcher's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) is used if it is set, and
    otherwise the call is a no-op. ``backend`` None takes PyTorch's
    default (NCCL for CUDA tensors, gloo for CPU ones). Returns whether
    this call initialized the group: a second call returns False, and a
    misconfiguration (no rank, a bad address, mismatched counts) raises.
    """
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return False
    explicit = ("init_method" in kwargs or "store" in kwargs
                or coordinator_address is not None)
    if not explicit and num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        dist.init_process_group(backend, **kwargs)
        return True
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "num_processes")
    if process_id is None:
        process_id = _env_int("RANK", "process_id")
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, world_size=num_processes,
                            rank=process_id, **kwargs)
    return True


def _env_int(name, arg):
    if name not in os.environ:
        raise ValueError(f"{arg} is not given and {name} is not set")
    return int(os.environ[name])


def make_global_mesh(model_parallel=1, devices="cuda"):
    """('data', 'model') mesh over every process of the group, one device
    each. Keep 'model' (atom sharding) within a host."""
    from lasso_tpu_torch.parallel.mesh import make_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_devices=n, model_parallel=model_parallel,
                     devices=devices)


def process_local_batch(global_batch_size):
    """Rows ``(start, end)`` of the global batch owned by this process (a
    contiguous split)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch_size // n_proc
    start = pid * per
    end = start + per if pid < n_proc - 1 else global_batch_size
    return start, end
