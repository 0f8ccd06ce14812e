"""Device-mesh construction and sharding helpers.

Counterpart of the JAX package's ``parallel/mesh.py``. The port runs one
process per device: a ('data', 'model') mesh of ``n // model_parallel`` by
``model_parallel`` ranks is a ``torch.distributed`` ``DeviceMesh``. The
sample axis shards over 'data' and, with ``shard_atoms``, the atom axis K
over 'model'. The sharding helpers return the DTensor placements over the
mesh's two dimensions (for ``torch.distributed.tensor.distribute_tensor``),
the counterparts of the JAX package's ``NamedSharding``s. Collectives are
explicit: the solvers and M-steps all-reduce over the 'data' group given
as their ``axis_name``.
"""

from __future__ import annotations

import torch.distributed as dist


def make_mesh(n_devices=None, model_parallel=1, devices="cuda"):
    """Build a ('data', 'model') mesh over ``n_devices`` processes, one a
    device of type ``devices`` ('cuda', or 'cpu' with gloo).

    ``n_devices`` defaults to the world size and must equal it. In a
    process with no process group yet, a one-rank group is made (on an
    in-memory store, no network) when ``n_devices`` is None or 1; a
    larger mesh needs :func:`lasso_tpu_torch.parallel.initialize` (or a
    launcher such as ``torchrun``) first.
    """
    if not dist.is_initialized() and n_devices in (None, 1):
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs one process per device, "
            f"and the process group has {world}")
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices do not split into "
                         f"model_parallel={model_parallel} columns")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(devices,
                            (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def _placements(data_split, atom_split):
    """DTensor placements over ('data', 'model'): a split of tensor
    dimension ``data_split`` over 'data' and ``atom_split`` over 'model'
    (None: replicated). Imported here, since ``torch.distributed.tensor``
    takes over a second to import."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if d is None else Shard(d)
                 for d in (data_split, atom_split))


def data_sharding(mesh):
    """Placements of batched per-sample tensors: [N, ...] split over
    'data'."""
    return _placements(0, None)


def code_sharding(mesh, shard_atoms=False):
    """Placements of codes z [N, K]: 'data' on N, and 'model' on K with
    ``shard_atoms``."""
    return _placements(0, 1 if shard_atoms else None)


def weight_sharding(mesh, shard_atoms=False):
    """Placements of the dictionary W [D, K]: replicated, or its columns
    split over 'model' with ``shard_atoms``."""
    return _placements(None, 1 if shard_atoms else None)


def replicated(mesh):
    return _placements(None, None)
