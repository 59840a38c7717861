"""Data parallelism over a mesh of ranks (port of
``segtpu/parallel/data_parallel.py``), with GSPMD's semantics: a sharded
step equals the single-device step on the same global batch.

One rank per device. Each rank holds the global batch's rows of its
block (``shard_batch``: a ``DTensor`` placed ``Shard(0)``, whose shape is
the global one) and a replica of the model and optimizer
(``replicate_state``: broadcast from rank 0). The engine's steps and
epochs (``segtpu_torch/train/engine.py``) take such batches as they take
plain ones, and then:

- the BatchNorms normalise by the global batch's statistics (a
  differentiable sum of per-channel sums over the ranks,
  ``models/backbones.py::BatchNorm2d``), as BatchNorm's batch mean under
  GSPMD is a global reduction;
- the logits and masks are gathered (with autograd, each rank's rows
  padded to the largest block) and the loss and the metrics are computed
  on the global batch on every rank: Dice, Tversky and the metrics sum
  over the whole batch, so a mean of per-rank losses would be another
  function;
- the gradients are summed over the ranks before the optimizer step.
  Every rank computes the same loss of the gathered rows, so the
  gather's backward hands each rank its own rows' gradient (no sum), and
  the sum of the ranks' parameter gradients is the global gradient.

With one rank in the mesh the step is the single-device step, op for
op. Blocks are the JAX package's ceil partition, so a batch that does
not divide by the world size, or has fewer rows than ranks, leaves the
last ranks short or empty, and the step still equals the single-device
one.

On a 2-D mesh ``("data", "spatial")`` a batch placed ``[Shard(0),
Shard(2)]`` (``torch.distributed.tensor.distribute_tensor``, or
``shard_batch(..., spatial_axis="spatial")``) also splits each image's
rows into bands over the spatial axis, as GSPMD does with
``P("data", "spatial")``: the model runs on the bands
(``parallel/spatial.py``), the BatchNorms' sums run over the whole mesh
and count the global height, and the gather, and the gradients' sum,
cover every rank of the mesh. A batch placed over ``data`` alone takes
the path above.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from segtpu_torch.core.dist import (all_reduce_, all_reduce_sum, broadcast_,
                                    create_mesh, gather_rows, process_rows)
from segtpu_torch.models.backbones import synced_batch_stats
from segtpu_torch.parallel.spatial import Bands, on_bands


def local_block(arr: torch.Tensor, mesh: DeviceMesh, axis: str = "data",
                dim: int = 0, spatial_axis: Optional[str] = None):
    """(this rank's block of the global batch ``arr``, a view, and the
    placements of ``shard_batch``)."""
    local, placements = arr, []
    for name in mesh.mesh_dim_names:
        d = dim if name == axis else dim + 2 if name == spatial_axis \
            else None
        if d is None:
            placements.append(Replicate())
            continue
        group = mesh.get_group(name)
        rows = process_rows(arr.shape[d], group.size(), group.rank())
        local = local.narrow(d, rows.start, rows.stop - rows.start)
        placements.append(Shard(d))
    return local, placements


def shard_batch(arr: torch.Tensor, mesh: DeviceMesh, axis: str = "data",
                dim: int = 0, spatial_axis: Optional[str] = None) -> DTensor:
    """The global batch ``arr`` (the same on every rank) as a ``DTensor``
    holding this rank's block of rows along ``dim`` (0, or 1 for the
    stacked micro-batches of ``train_step_accum``), sharded over
    ``axis``; with ``spatial_axis``, also this rank's band of the images'
    rows (dim ``dim + 2``) over that axis: ``distribute_tensor``'s
    blocks, with no communication."""
    local, placements = local_block(arr, mesh, axis, dim, spatial_axis)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=arr.shape, stride=arr.stride())


def _tensors(obj):
    """The tensors of a state, model, optimizer or container, in a fixed
    order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.state_dict().values()
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for k in sorted(group):
                if k != "params" and isinstance(group[k], torch.Tensor):
                    yield group[k]
        for p in (p for g in obj.param_groups for p in g["params"]):
            for k in sorted(obj.state.get(p, {})):
                yield from _tensors(obj.state[p][k])
    elif isinstance(obj, dict):
        for k in obj:
            yield from _tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif hasattr(obj, "model"):    # TrainState
        yield from _tensors(obj.model)
        if getattr(obj, "optimizer", None) is not None:
            yield from _tensors(obj.optimizer)


def replicate_state(state: Any, mesh: DeviceMesh, axis: str = "data"):
    """Every rank's ``state`` (a ``TrainState``, a model, an optimizer, or
    dicts, lists and tuples of tensors) takes rank 0's values, in place:
    parameters, buffers and the optimizer's state and learning rate. One
    broadcast per dtype and device, of the tensors laid end to end.
    Returns ``state``."""
    group = mesh.get_group(axis)
    src = torch.distributed.get_global_rank(group, 0)
    buckets = {}
    for t in _tensors(state):
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = broadcast_(torch.cat([t.detach().reshape(-1) for t in ts]),
                          src, group)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            with torch.no_grad():
                t.copy_(v.view_as(t))
    return state


class StepSync:
    """A sharded step's view of its batch: ``rows`` global rows in blocks
    on the ranks of ``group`` (None: every rank holds all of them), and
    with ``bands`` (a ``parallel.spatial.Bands``) each image's rows in
    bands over the spatial axis."""

    def __init__(self, group, rows: int, bands: Optional[Bands] = None):
        self.group, self.rows, self.bands = group, int(rows), bands
        self._groups = [g for g in (
            group, bands.group if bands is not None else None)
            if g is not None]

    def count(self, x: torch.Tensor) -> int:
        """The values per channel of the global batch at ``x``'s level
        (the BatchNorms' count): its rows times that level's global
        height and width."""
        n = self.bands.n if self.bands is not None else 1
        return self.rows * x.shape[2] * n * x.shape[3]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over every rank of the mesh (the BatchNorms'
        sums): one collective per mesh axis."""
        for g in self._groups:
            t = all_reduce_sum(t, g)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of ``t`` (its bands' whole images, then its
        rows), on every rank, with autograd."""
        if self.bands is not None:
            t = self.bands.gather(t)
        if self.group is not None:
            t = gather_rows(t, self.rows, self.group)
        return t

    def reduce_gradients(self, params) -> None:
        """Sum the parameters' gradients over every rank of the mesh: one
        collective per mesh axis of the gradients laid end to end."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in self._groups:
            all_reduce_(flat, g)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


@contextlib.contextmanager
def synced(model: torch.nn.Module, sync: Optional[StepSync]):
    """Within it, ``model``'s forwards take ``sync``'s view of the batch:
    train-mode BatchNorms the global batch's statistics, and on bands
    every layer its halo rows (``on_bands``); with ``sync`` None, nothing
    changes."""
    bands = sync.bands if sync is not None else None
    with synced_batch_stats(model, sync), on_bands(model, bands):
        yield


def local_batch(images, masks):
    """(this rank's images, its masks, the step's ``StepSync``) of a
    sharded batch (B, 1, H, W), or stacked micro-batches (A, B, 1, H, W):
    its rows sharded over one mesh axis, and its images' rows (H) over
    another or none. A plain batch, or one sharded over single ranks,
    passes through with ``None``, so that its step is the single-device
    one."""
    if not isinstance(images, DTensor):
        return images, masks, None
    mesh, nd = images.device_mesh, images.ndim
    rows = height = None
    for mdim, p in enumerate(images.placements):
        if not isinstance(p, Shard):
            continue
        if p.dim % nd == nd - 4:
            rows = mdim
        elif p.dim % nd == nd - 2:
            height = mdim
        else:
            raise ValueError(f"a batch {tuple(images.shape)} sharded along "
                             f"dim {p.dim}: only its rows (dim {nd - 4}) "
                             f"and its images' rows (dim {nd - 2}) can be")
    group = mesh.get_group(rows) if rows is not None else None
    group = group if group is not None and group.size() > 1 else None
    band_group = mesh.get_group(height) if height is not None else None
    bands = Bands(band_group, images.shape[nd - 2]) \
        if band_group is not None and band_group.size() > 1 else None
    sync = StepSync(group, images.shape[nd - 4], bands) \
        if group is not None or bands is not None else None
    return images.to_local(), masks.to_local(), sync


class ShardedLoader:
    """A ``DeviceDataLoader`` whose batches come out sharded: each global
    batch is the loader's own (the same permutation on every rank, from
    the same generator), and each rank keeps its block of rows."""

    def __init__(self, loader, mesh: DeviceMesh, axis: str = "data"):
        self.loader, self.mesh, self.axis = loader, mesh, axis

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def batches(self, generator: Optional[torch.Generator] = None):
        """(full batches: a list of sharded images and one of masks,
        remainder pair or None), as ``DeviceDataLoader.batches``."""
        (fi, fm), rem = self.loader.batches(generator)
        shard = lambda t: shard_batch(t, self.mesh, self.axis)
        full = ([shard(x) for x in fi], [shard(y) for y in fm])
        return full, (None if rem is None else tuple(map(shard, rem)))


def shard_loader(loader, mesh: DeviceMesh, axis: str = "data"
                 ) -> ShardedLoader:
    """``loader`` with its batches sharded over ``axis``."""
    return ShardedLoader(loader, mesh, axis)


class DataParallel:
    """A mesh and the placements of a data-parallel run::

        dp = DataParallel()                     # every rank, 1-D mesh
        state = dp.replicate(state)
        loader = dp.shard_loader(loader)
        state, metrics = engine.run_train_epoch(state, loader, lr)
        state, metrics = engine.train_step(state, dp.shard(x), dp.shard(y))
    """

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 axis: str = "data", *, device="cuda"):
        self.mesh = mesh if mesh is not None else create_mesh(
            axis_names=(axis,), device=device)
        self.axis = axis

    @property
    def n_devices(self) -> int:
        return self.mesh.size()

    def shard(self, arr: torch.Tensor, dim: int = 0,
              spatial_axis: Optional[str] = None) -> DTensor:
        return shard_batch(arr, self.mesh, self.axis, dim, spatial_axis)

    def replicate(self, state):
        return replicate_state(state, self.mesh, self.axis)

    def shard_loader(self, loader) -> ShardedLoader:
        return shard_loader(loader, self.mesh, self.axis)
