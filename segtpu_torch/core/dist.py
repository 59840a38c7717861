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
the spatial and tiled predictors share are here too, with the
differentiable halo exchange of row-sharded training. On a gloo group a
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


def all_reduce_(t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place: ``t`` reduced by ``op`` (a sum unless told) over
    ``group``."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
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


def exchange_rows(up: torch.Tensor, down: torch.Tensor, group):
    """Neighbour exchange over the ranks of ``group``, in rank order: each
    rank sends ``up`` to the rank above (rank − 1) and ``down`` to the
    rank below, by point-to-point sends and receives (never a gather).
    Returns (the rank above's ``down``, the rank below's ``up``), each
    None where there is no such rank; every rank's ``up`` and ``down``
    have the same shapes as its neighbours'. A direction whose payload is
    empty moves nothing."""
    n, r = group.size(), group.rank()
    host = _via_host(up, group)
    stage = (lambda t: t.contiguous().cpu()) if host \
        else (lambda t: t.contiguous())
    up, down = stage(up), stage(down)
    from_above = torch.empty_like(down) if r > 0 else None
    from_below = torch.empty_like(up) if r < n - 1 else None
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        if up.numel():
            ops.append(dist.P2POp(dist.isend, up, peer, group))
        if down.numel():
            ops.append(dist.P2POp(dist.irecv, from_above, peer, group))
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        if down.numel():
            ops.append(dist.P2POp(dist.isend, down, peer, group))
        if up.numel():
            ops.append(dist.P2POp(dist.irecv, from_below, peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_above, from_below


class _HaloRows(torch.autograd.Function):
    """``halo_rows``; the backward is its adjoint: the gradients of the
    received rows go back to the ranks that own them and are added into
    their edge rows, and those of the fill rows are dropped."""

    @staticmethod
    def forward(ctx, x, top, bottom, fill, group):
        ctx.top, ctx.bottom, ctx.group = top, bottom, group
        h = x.shape[2]
        from_above, from_below = exchange_rows(
            x[:, :, :bottom], x[:, :, h - top:], group)
        edge = lambda k: x.new_full((*x.shape[:2], k, x.shape[3]), fill)
        top_rows = edge(top) if from_above is None \
            else from_above.to(x.device)
        bottom_rows = edge(bottom) if from_below is None \
            else from_below.to(x.device)
        return torch.cat([top_rows, x, bottom_rows], dim=2)

    @staticmethod
    def backward(ctx, grad):
        top, bottom = ctx.top, ctx.bottom
        h = grad.shape[2] - top - bottom
        gx = grad[:, :, top:top + h].clone()
        from_above, from_below = exchange_rows(
            grad[:, :, :top], grad[:, :, top + h:], ctx.group)
        if from_above is not None and bottom:
            gx[:, :, :bottom] += from_above.to(gx.device)
        if from_below is not None and top:
            gx[:, :, h - top:] += from_below.to(gx.device)
        return gx, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, fill: float,
              group) -> torch.Tensor:
    """This rank's band ``x`` (N, C, h, W) of images cut into row bands
    over ``group`` (rank order, top to bottom), with ``top`` rows of the
    band above on top and ``bottom`` rows of the band below beneath;
    at the images' own top and bottom edges, rows of ``fill`` (a layer's
    own padding). Differentiable (``_HaloRows``)."""
    if top > x.shape[2] or bottom > x.shape[2]:
        raise ValueError(f"halo of {top} + {bottom} rows exceeds the band "
                         f"height {x.shape[2]}")
    return _HaloRows.apply(x, int(top), int(bottom), float(fill), group)


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


class _AmaxOverRanks(torch.autograd.Function):
    """``amax_over_ranks``. The backward sums the output's gradient over
    the ranks (each saw only its own band's share of its use) and splits
    it evenly over the maximum's occurrences in all the bands, as
    ``amax`` splits it over one tensor's."""

    @staticmethod
    def forward(ctx, x, group):
        m = all_reduce_(x.amax((2, 3), keepdim=True), group,
                        op=dist.ReduceOp.MAX)
        hit = x == m
        ties = all_reduce_(hit.sum((2, 3), keepdim=True,
                                   dtype=torch.float32), group)
        ctx.group = group
        ctx.save_for_backward(hit, ties)
        return m

    @staticmethod
    def backward(ctx, grad):
        hit, ties = ctx.saved_tensors
        g = all_reduce_(grad.clone(), ctx.group)
        return (g * hit / ties).to(grad.dtype), None


def amax_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The maximum over dims (2, 3) of ``x`` (N, C, h, W) and its
    counterparts on the ranks of ``group`` (N, C, 1, 1), on every rank;
    differentiable."""
    return _AmaxOverRanks.apply(x, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group``."""
    return _AllReduceSum.apply(t, group)


def gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Differentiable ``all_gather_rows``."""
    return _GatherRows.apply(t, n, group)
