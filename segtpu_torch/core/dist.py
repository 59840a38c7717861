"""Device, process-group and mesh plumbing (port of
``segtpu/core/dist.py``).

JAX sees every device of a host in one process and shards arrays over a
``Mesh``; PyTorch runs one process (a rank) per device, joined in a
``torch.distributed`` process group. ``init_process_group`` brings the
group up (NCCL for CUDA tensors, gloo for CPU tensors, or the caller's
explicit ``backend``: never one as a fallback for another) and
``create_mesh`` lays a ``DeviceMesh`` over its ranks, usable as
``with mesh:`` where the JAX package's tests enter a ``Mesh``.

The collectives the data-parallel step, the synchronised BatchNorm and
the spatial and tiled predictors share are here too. On a gloo group a
CUDA tensor goes through host memory explicitly (a copy to the host, the
collective, a copy back), which is how the two ranks of one card talk
when NCCL refuses them ("Duplicate GPU detected"); NCCL takes device
tensors.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from segtpu_torch import resolve_device

# How long a collective may wait for the other ranks before it raises, so
# that a rank that died fails its peers instead of hanging them.
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def get_device(verbose: bool = True, device="cuda") -> torch.device:
    """The device entry points run on (``resolve_device``); prints its
    kind as the reference does (utils.py:153-167)."""
    dev = resolve_device(device)
    if verbose:
        print(f"Using {dev.type.upper()} device")
    return dev


def device_kind(device="cuda") -> str:
    return resolve_device(device).type


def init_process_group(init_method: str, world_size: int, rank: int, *,
                       device="cuda", backend: Optional[str] = None) -> str:
    """Join the default process group at ``init_method`` (``file://`` or
    ``tcp://host:port``) as ``rank`` of ``world_size``. The backend is
    ``backend`` where given, else NCCL for a CUDA ``device`` and gloo for
    the CPU. A CUDA device with an index becomes the current device.
    Returns the backend's name."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=GROUP_TIMEOUT)
    return backend


def create_mesh(axis_sizes: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("data",),
                devices: Optional[Sequence[int]] = None, *,
                device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of shape ``axis_sizes`` with ``axis_names`` over
    the ranks ``devices`` (default: every rank of the initialised group),
    for tensors on ``device``'s type. ``axis_sizes`` defaults to all ranks
    on the first axis, 1 on the others, as in the JAX package."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group; call "
                           "segtpu_torch.core.dist.init_process_group first")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if axis_sizes is None:
        axis_sizes = (len(ranks),) + (1,) * (len(axis_names) - 1)
    n = 1
    for s in axis_sizes:
        n *= int(s)
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(
        tuple(int(s) for s in axis_sizes))
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=tuple(axis_names))


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = getattr(_mesh_resources, "mesh_stack", [])
    return stack[-1] if stack else None


def batch_sharding(mesh: DeviceMesh, axis: str = "data"):
    """The placements that split the leading (batch) axis over ``axis``
    (one per mesh dimension)."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh):
    return [Replicate()] * mesh.ndim


def process_rows(n: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s contiguous block of ``n`` rows, the JAX package's
    ceil partition (``per = -(-n // world)``); the last ranks' blocks may
    be short or empty."""
    per = -(-n // world)
    return slice(min(rank * per, n), min((rank + 1) * per, n))


# ------------------------------------------------------------ collectives

def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place: ``t`` takes rank ``src``'s values (a global rank)."""
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The ``n`` rows that the ranks of ``group`` hold in ceil-partition
    blocks (``process_rows``), concatenated in rank order on every rank.
    Each rank pads its block to the largest one so that the collective's
    shapes agree; the padding is cut away."""
    world = dist.get_world_size(group)
    per = -(-n // world)
    pad = per - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    t = t.contiguous()
    src = t.cpu() if _via_host(t, group) else t
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)[:n].to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` whose backward hands each rank the gradient of
    its own rows. Every rank computes the same function of the gathered
    rows, so that slice is the whole derivative: no sum over ranks."""

    @staticmethod
    def forward(ctx, t, n, group):
        rows = process_rows(n, dist.get_world_size(group),
                            dist.get_rank(group))
        ctx.rows = rows
        return all_gather_rows(t, n, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group``."""
    return _AllReduceSum.apply(t, group)


def gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Differentiable ``all_gather_rows``."""
    return _GatherRows.apply(t, n, group)
