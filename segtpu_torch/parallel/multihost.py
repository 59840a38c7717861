"""Multi-process input sharding (port of ``segtpu/parallel/multihost.py``).

Each rank loads only its block of the global dataset
(``process_local_slice``, the JAX package's ceil partition) and
``global_batch_from_local`` presents the blocks as one global batch, a
``DTensor`` placed ``Shard(0)`` whose shape is the global one, without
gathering the rows: each rank keeps its own on its device. The engine's
steps take it as they take ``shard_batch``'s. With one rank, local ==
global.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from segtpu_torch.core.dist import all_reduce_, batch_sharding, process_rows


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def global_batch_from_local(local_batch, mesh: DeviceMesh,
                            axis: str = "data") -> DTensor:
    """This rank's rows ``local_batch`` (local_B, ...), a tensor or an
    array, as its block of the global batch sharded over ``axis``. The
    global row count is the sum of the ranks' (one collective of one
    number); each rank's block must be its ``process_local_slice`` of
    it."""
    local = torch.as_tensor(np.asarray(local_batch) if not isinstance(
        local_batch, torch.Tensor) else local_batch).to(_mesh_device(mesh))
    group = mesh.get_group(axis)
    count = torch.tensor([local.shape[0]], dtype=torch.int64,
                         device=local.device)
    n = int(all_reduce_(count, group).item())
    want = process_rows(n, group.size(), group.rank())
    if local.shape[0] != want.stop - want.start:
        raise ValueError(
            f"rank {group.rank()} holds {local.shape[0]} rows; its block of "
            f"{n} global rows is {want.stop - want.start} "
            f"(process_local_slice)")
    shape = (n, *local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, batch_sharding(mesh, axis),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def process_local_slice(n_global: int) -> slice:
    """Which rows of a global dataset this rank should load (contiguous
    blocks, ``per = -(-n // world)``)."""
    if not dist.is_initialized():
        return slice(0, n_global)
    return process_rows(n_global, dist.get_world_size(), dist.get_rank())
