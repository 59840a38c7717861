"""Whole-training-run fusion (port of ``segtpu/train/fused_run.py``): the
training run as replayed CUDA graphs.

The JAX module runs the whole epoch loop as one jit-compiled program (a
``lax.scan`` over epochs), so that the host dispatches nothing per step.
Here each kind of step is captured once as a CUDA graph and replayed: the
training step at the full batch and at the remainder, the validation step
at both, and the epoch's bookkeeping. A replay enqueues the thousands of
kernels of a step with one host call, where the stepwise loop
(``train_model``) dispatches each of them from Python.

The semantics are the stepwise loop's, exactly, as the JAX module's are:
ReduceLROnPlateau in max mode with a relative threshold (including its
``best >= 0`` branch), the best weights when the validation IoU is
strictly greater (from 0.0), early stopping with ``min_delta`` (the first
epoch always counts as better), fixed validation batches with their
remainder, and sample-weighted epoch metrics. Each epoch's permutation is
drawn outside the graphs, from the caller's generator and through the
same loader call as the stepwise loop, so both train on the same batches;
the host copies each batch into the static input of its graph and
replays.

What stays on the device: the weights, BatchNorm statistics, the
optimizer's moments, LR and step counts (``DeviceOptimizer``), the metric
totals, the scheduler's and early stopping's state, the best weights and
the histories. The decisions compare in float64, as Python compares them
in the stepwise loop. The host reads one flag per epoch, early
stopping's, and stops replaying once it is set (the JAX module masks the
epochs after it, since a scan cannot break); the histories come back in
one fetch at the end.

Runners are kept in an ``LRUCache`` keyed on everything their graphs
hold: the model's configuration and routing, the loss, the optimizer's
rule and hyperparameters, the compute and parameter dtypes, remat, the
training and validation shapes and the placement. Each run loads its
whole starting state into the runner (weights, BatchNorm statistics and
counts, optimizer moments and step count, LR, scheduler and
early-stopping settings and state) and copies its results out, so a
second run of equal shapes (the next fold of a CV) replays the graphs
that the first one captured.

On CUDA, a runner's first run calls each step twice on a side stream
before capturing it (the kernels' first call builds and loads them there,
the optimizer's state exists already, cuDNN picks its algorithms), then
loads the run's state again. A failed capture or replay raises; nothing
runs the eager loop in its place. On the CPU (``device="cpu"``) the
runner calls the same step functions eagerly with the same bookkeeping,
and its numbers are the stepwise loop's, bit for bit.

On a mesh (``mesh=``, or the mesh entered with ``with mesh:``) the run
is data-parallel with GSPMD's semantics, as the JAX module's is when
its arrays are sharded: it equals the one-process run on the same
global batches. Every rank holds the whole training and validation set
and a replica of the state (``parallel.replicate_state``), draws the
same permutation from its equally seeded generator, and copies its
block of each batch (``process_rows``'s ceil partition: the last ranks'
may be short or empty) into the static input of its graph. Each static
input is wrapped once, before capture, in the ``DTensor`` that
``parallel.shard_batch`` makes (no communication), so the captured
steps take the data-parallel path of the engine: the BatchNorms' sums
over the ranks, the logits and masks gathered for the loss and the
metrics, the gradients summed before the update
(``parallel/data_parallel.py``). With ``spatial_axis`` each image's
rows are cut into bands over that axis too, and the halo rows'
point-to-point exchanges join the captured step. The collectives are
captured into the graphs with the rest, which NCCL allows; gloo stages
a CUDA tensor through host memory (``core/dist.py``), which a graph
cannot capture, so a CUDA runner on a gloo mesh raises before it
captures anything (``graphs=False`` runs the same steps eagerly there).
The metrics are the global batch's on every rank, so every rank reads
the same early-stopping flag: no collective is added for it.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from segtpu_torch.core.caching import LRUCache
from segtpu_torch.core.dist import current_mesh
from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.kernels import CountedGraph
from segtpu_torch.models.attention import invalidate_folds
from segtpu_torch.parallel.data_parallel import local_block
from segtpu_torch.train.engine import METRIC_KEYS, TrainEngine, TrainState
from segtpu_torch.train.optim import set_learning_rate

IOU = METRIC_KEYS.index("iou")
# the kinds of step, in the order they are captured and replayed
STEPS = ("train_full", "train_rem", "eval_full", "eval_rem", "book")
WARMUP_CALLS = 2
# the model attributes that route its forward (read when it is captured)
ROUTING = ("fuse", "fuse_gate", "fuse_head", "fuse_min_cin",
           "fuse_min_work", "reparam_in_train", "stem_s2d")
RUNNERS = LRUCache(2)


def _fn_key(fn):
    """A hashable stand-in for a loss function: a ``partial`` by its
    function and arguments, so that two engines of one config share a
    key; anything else by identity (the runner holds the function, so
    its id is not reused while the runner is cached)."""
    key = (fn.func, fn.args, tuple(sorted(fn.keywords.items()))) \
        if isinstance(fn, functools.partial) else fn
    try:
        hash(key)
    except TypeError:
        return ("id", id(fn))
    return key


class Placement:
    """Where a runner's batches go: this rank's blocks of their rows over
    the mesh axis ``axis``, and with ``spatial_axis`` its band of their
    images' rows over that axis."""

    def __init__(self, mesh, axis: str = "data",
                 spatial_axis: Optional[str] = None):
        names = mesh.mesh_dim_names
        for a in (axis, spatial_axis):
            if a is not None and a not in names:
                raise ValueError(f"fused run: no axis {a!r} in the mesh "
                                 f"{names}")
        self.mesh, self.axis, self.spatial_axis = mesh, axis, spatial_axis
        self.groups = tuple(mesh.get_group(n) for n in names)
        self.backends = tuple(sorted({dist.get_backend(g)
                                      for g in self.groups}))

    def key(self) -> tuple:
        """The mesh's shape and axis names, the axes, this rank, the
        backends and the process groups themselves: a runner of one
        placement is never replayed under another, nor under none, nor
        under a mesh made anew at the same shape (a runner's graphs hold
        its groups' communicators). The runner holds its placement's
        groups, so their ids are not reused while it is cached."""
        return (tuple(self.mesh.shape), self.mesh.mesh_dim_names,
                self.axis, self.spatial_axis, dist.get_rank(),
                self.backends, tuple(id(g) for g in self.groups))

    def block(self, t: torch.Tensor):
        """(this rank's block of the global batch ``t``, a view, and its
        placements)."""
        return local_block(t, self.mesh, self.axis,
                           spatial_axis=self.spatial_axis)

    def static(self, t: torch.Tensor) -> DTensor:
        """A static copy of this rank's block of ``t`` as a ``DTensor``
        of ``t``'s global shape (``shard_batch``'s, over the copy)."""
        local, placements = self.block(t)
        return DTensor.from_local(local.clone(), self.mesh, placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())


def _param_dtype(state: TrainState) -> torch.dtype:
    return next(state.model.parameters()).dtype


def runner_key(engine: TrainEngine, state: TrainState, train_images,
               val_images, batch_size: int,
               placement: Optional[Placement] = None) -> tuple:
    """Everything that shapes a runner's graphs."""
    (group,) = state.optimizer.param_groups
    opt = tuple(sorted((k, v) for k, v in group.items()
                       if k not in ("params", "lr", "initial_lr")))
    model_kw = tuple(sorted((k, v) for k, v in engine.model_kwargs.items()
                            if k != "final_bias_prior"))
    return (model_kw, tuple(getattr(state.model, a) for a in ROUTING),
            _fn_key(engine.loss_fn), engine.multiclass, engine.remat,
            engine.compute_dtype, _param_dtype(state), str(engine.device),
            state.optimizer.rule, opt, int(batch_size),
            tuple(train_images.shape), train_images.stride(),
            train_images.dtype, tuple(val_images.shape),
            val_images.stride(), val_images.dtype,
            None if placement is None else placement.key())


class FusedRunner:
    """The model, optimizer, device-side bookkeeping and (on CUDA) the
    captured graphs of fused runs of one shape; see the module
    docstring. ``placement`` (a ``Placement``) makes its runs
    data-parallel. ``stats`` counts runs, captures, replays per step,
    warm-up calls and host reads."""

    def __init__(self, engine: TrainEngine, state: TrainState, n: int,
                 n_val: int, graphs: Optional[bool] = None,
                 placement: Optional[Placement] = None):
        self.engine = engine
        self.device = engine.device
        # graphs=False calls the steps eagerly on the card too: the
        # reference that holds the replays to the same steps unreplayed
        self.graphs_on = (self.device.type == "cuda") if graphs is None \
            else bool(graphs)
        if self.graphs_on and self.device.type != "cuda":
            raise ValueError("FusedRunner: CUDA graphs need a CUDA device")
        self.placement = placement
        if self.graphs_on and placement is not None \
                and placement.backends != ("nccl",):
            raise RuntimeError(
                f"FusedRunner: a CUDA graph cannot capture the collectives "
                f"of a {'/'.join(placement.backends)} mesh: gloo stages CUDA "
                f"tensors through host memory (core/dist.py). Use an NCCL "
                f"process group, or graphs=False to run the same steps "
                f"eagerly")
        self.n, self.n_val = int(n), int(n_val)
        # in the state's parameter dtype (a float64 state trains in
        # float64, as it does stepwise)
        self.model = engine.build_model().to(_param_dtype(state))
        for a in ROUTING:
            setattr(self.model, a, getattr(state.model, a))
        self.opt = state.optimizer.like(self.model.parameters())
        self.sd = self.model.state_dict()
        self.best = {k: torch.empty_like(v) for k, v in self.sd.items()}
        dev = self.device
        f64 = dict(dtype=torch.float64, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        flag = dict(dtype=torch.bool, device=dev)
        # metric totals and the epoch's rows (written by the bookkeeping)
        self.ttot = torch.zeros(len(METRIC_KEYS), device=dev)
        self.vtot = torch.zeros(len(METRIC_KEYS), device=dev)
        self.trow = torch.zeros(len(METRIC_KEYS), device=dev)
        self.vrow = torch.zeros(len(METRIC_KEYS), device=dev)
        self.lrow = torch.zeros((), **f64)
        # ReduceLROnPlateau: settings and state
        self.sched_on = torch.zeros((), **flag)
        self.factor, self.threshold, self.min_lr = (
            torch.zeros((), **f64) for _ in range(3))
        self.patience = torch.zeros((), **i64)
        self.s_best = torch.zeros((), **f64)
        self.s_first = torch.zeros((), **flag)
        self.s_bad = torch.zeros((), **i64)
        # best weights
        self.best_iou = torch.zeros((), **f64)
        self.best_found = torch.zeros((), **flag)
        self.best_epoch = torch.zeros((), **i64)
        self.epoch = torch.zeros((), **i64)
        # early stopping: settings and state
        self.es_patience = torch.zeros((), **i64)
        self.es_min_delta = torch.zeros((), **f64)
        self.e_best = torch.zeros((), **f64)
        self.e_first = torch.zeros((), **flag)
        self.e_count = torch.zeros((), **i64)
        self.stopped = torch.zeros((), **flag)
        # static inputs by kind, made from the first batches of each kind
        # (under a placement ``DTensor``s over this rank's blocks)
        self.inputs: Dict[str, tuple] = {}
        self.graphs: Dict[str, CountedGraph] = {}
        self.stats = dict(runs=0, captures=0, capture_s=0.0, host_reads=0,
                          warmup_calls={}, replays={})

    # --------------------------------------------------------- the steps

    def _train(self, kind: str) -> None:
        """The engine's training step with this runner's optimizer, its
        metrics added to the totals (weighted by the global batch's
        rows)."""
        x, y = self.inputs[kind]
        self.ttot += self.engine._train_step_vec(
            TrainState(self.model, self.opt), x, y) * x.shape[0]

    def _eval(self, kind: str) -> None:
        x, y = self.inputs[kind]
        self.vtot += self.engine._eval_step_vec(TrainState(self.model),
                                                x, y) * x.shape[0]

    def _book(self) -> None:
        """The epoch's metrics, ReduceLROnPlateau, best weights and early
        stopping, as ``train_model`` runs them after each epoch."""
        where = torch.where
        self.trow.copy_(self.ttot / self.n)
        self.vrow.copy_(self.vtot / self.n_val)
        iou = self.vrow[IOU].double()
        # ReduceLROnPlateau, mode max, relative threshold
        better = self.s_first | where(
            self.s_best >= 0, iou > self.s_best * (1 + self.threshold),
            iou > self.s_best * (1 - self.threshold))
        bad = where(better, 0, self.s_bad + 1)
        cut = bad > self.patience
        lr = self.opt.lr
        new_lr = where(cut, torch.maximum(lr * self.factor, self.min_lr), lr)
        on = self.sched_on
        self.s_best.copy_(where(on & better, iou, self.s_best))
        self.s_bad.copy_(where(on, where(cut, 0, bad), self.s_bad))
        self.s_first.copy_(self.s_first & ~on)
        lr.copy_(where(on, new_lr, lr))
        self.lrow.copy_(lr)
        # best weights: strictly greater
        improved = iou > self.best_iou
        for k, t in self.sd.items():
            self.best[k].copy_(where(improved, t, self.best[k]))
        self.best_iou.copy_(where(improved, iou, self.best_iou))
        self.best_found.logical_or_(improved)
        self.best_epoch.copy_(where(improved, self.epoch, self.best_epoch))
        # early stopping
        es_better = self.e_first | (iou > self.e_best + self.es_min_delta)
        self.e_best.copy_(where(es_better, iou, self.e_best))
        self.e_count.copy_(where(es_better, 0, self.e_count + 1))
        self.stopped.logical_or_(self.e_count >= self.es_patience)
        self.e_first.fill_(False)
        self.epoch += 1
        self.ttot.zero_()
        self.vtot.zero_()

    def _call(self, kind: str) -> None:
        if kind == "book":
            self._book()
        elif kind.startswith("train"):
            self._train(kind)
        else:
            self._eval(kind)

    def feed(self, kind: str, images: torch.Tensor,
             masks: torch.Tensor) -> None:
        """A global batch into the static input of step ``kind`` (this
        rank's block of it under a placement)."""
        for static, t in zip(self.inputs[kind], (images, masks)):
            if self.placement is None:
                static.copy_(t)
            else:      # a view of the static copy
                static.to_local().copy_(self.placement.block(t)[0])

    def replay(self, kind: str) -> None:
        """Run step ``kind`` on its static input: its graph's replay on
        CUDA, the step itself on the CPU (or with ``graphs=False``)."""
        if self.graphs_on:
            self.graphs[kind].replay()
        else:
            self._call(kind)
        self.stats["replays"][kind] = self.stats["replays"].get(kind, 0) + 1

    # ---------------------------------------------------------- capture

    def _prepare(self, batches: List[tuple]) -> None:
        """Static inputs shaped and strided as the first batch of each
        kind (as the stepwise loop's batches, so each op sees the layout
        it sees there); on CUDA, warm-up calls and the captures."""
        static = torch.clone if self.placement is None \
            else self.placement.static
        for x, y, kind in batches:
            if kind not in self.inputs:
                self.inputs[kind] = (static(x), static(y))
        if not self.graphs_on:
            return
        t0 = time.perf_counter()
        kinds = [k for k in STEPS if k in self.inputs or k == "book"]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                for kind in kinds:
                    self._call(kind)
                    w = self.stats["warmup_calls"]
                    w[kind] = w.get(kind, 0) + 1
        torch.cuda.current_stream(self.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for kind in kinds:
            graph = CountedGraph()
            with graph.capture(pool=pool):
                self._call(kind)
            self.graphs[kind] = graph
        torch.cuda.synchronize(self.device)
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------ a run

    @torch.no_grad()
    def load(self, state: TrainState, lr0: float,
             scheduler_params: Optional[Dict], es_patience: int,
             es_min_delta: float) -> None:
        """The run's whole starting state into the runner."""
        self.model.load_state_dict(state.model.state_dict())
        invalidate_folds(self.model)
        self.opt.copy_from(state.optimizer)
        set_learning_rate(self.opt, lr0)
        for k, t in self.sd.items():
            self.best[k].copy_(t)
        sp = scheduler_params or {}
        self.sched_on.fill_(scheduler_params is not None)
        self.factor.fill_(float(sp.get("factor", 0.5)))
        self.patience.fill_(int(sp.get("patience", 3)))
        self.threshold.fill_(float(sp.get("threshold", 1e-4)))
        self.min_lr.fill_(float(sp.get("min_lr", 0.0)))
        self.es_patience.fill_(int(es_patience))
        self.es_min_delta.fill_(float(es_min_delta))
        for t in (self.ttot, self.vtot, self.s_best, self.s_bad,
                  self.best_iou, self.best_epoch, self.epoch, self.e_best,
                  self.e_count):
            t.zero_()
        for t in (self.s_first, self.e_first):
            t.fill_(True)
        for t in (self.best_found, self.stopped):
            t.fill_(False)

    def run(self, state: TrainState, train_loader: DeviceDataLoader,
            val_loader: DeviceDataLoader, generator, num_epochs: int,
            lr0: float, scheduler_params: Optional[Dict], es_patience: int,
            es_min_delta: float) -> Dict:
        self.stats["runs"] += 1
        start = (state, lr0, scheduler_params, es_patience, es_min_delta)
        self.load(*start)
        (vfi, vfm), vrem = val_loader.batches()
        val = [(vfi[i], vfm[i], "eval_full") for i in range(vfi.shape[0])]
        if vrem is not None:
            val.append((*vrem, "eval_rem"))
        dev = self.device
        th = torch.zeros(max(num_epochs, 0), len(METRIC_KEYS), device=dev)
        vh = torch.zeros_like(th)
        lh = torch.zeros(max(num_epochs, 0), dtype=torch.float64,
                         device=dev)
        ran = 0
        for e in range(num_epochs):
            (fi, fm), rem = train_loader.batches(generator)
            batches = [(fi[i], fm[i], "train_full")
                       for i in range(fi.shape[0])]
            if rem is not None:
                batches.append((*rem, "train_rem"))
            if not self.inputs:
                self._prepare(batches + val)
                self.load(*start)
            for x, y, kind in batches + val:
                self.feed(kind, x, y)
                self.replay(kind)
            self.replay("book")
            th[e].copy_(self.trow)
            vh[e].copy_(self.vrow)
            lh[e].copy_(self.lrow)
            ran = e + 1
            self.stats["host_reads"] += 1
            if bool(self.stopped):
                break
        return self._results(state, th[:ran], vh[:ran], lh[:ran], lr0)

    def _hand_back(self, optimizer, lr: float) -> None:
        """The runner's moments and step counts into ``optimizer``, at
        ``lr``, as the stepwise loop leaves its own."""
        optimizer.copy_from(self.opt)
        set_learning_rate(optimizer, lr)

    @torch.no_grad()
    def _results(self, state: TrainState, th, vh, lh, lr0) -> Dict:
        """One fetch of the histories and the scalars; the final and the
        best weights and the optimizer's state copied out."""
        ran = th.shape[0]
        packed = torch.cat([
            th.double().flatten(), vh.double().flatten(), lh,
            torch.stack([self.best_iou, self.best_found.double(),
                         self.best_epoch.double()])]).cpu()
        self.stats["host_reads"] += 1
        k = len(METRIC_KEYS)
        rows = lambda h: [dict(zip(METRIC_KEYS, r))
                          for r in h.view(ran, k).tolist()]
        train_h = rows(packed[:ran * k])
        val_h = rows(packed[ran * k:2 * ran * k])
        lr_h = packed[2 * ran * k:2 * ran * k + ran].tolist()
        best_iou, found, best_epoch = packed[-3:].tolist()
        found = bool(found)
        # the LR the last epoch ran at, as the stepwise loop leaves it in
        # its optimizer
        last_lr = lr_h[-2] if ran > 1 else lr0
        final_state = state
        if found:
            final_state = TrainState(copy.deepcopy(state.model))
            final_state.model.load_state_dict(self.sd)
            final_state.optimizer = state.optimizer.like(
                final_state.model.parameters())
            self._hand_back(final_state.optimizer, last_lr)
            invalidate_folds(final_state.model)
        state.model.load_state_dict(self.best if found else self.sd)
        invalidate_folds(state.model)
        self._hand_back(state.optimizer, last_lr)
        return {
            "train_history": train_h,
            "val_history": val_h,
            "lr_history": lr_h,
            "best_iou": best_iou,
            "best_found": found,
            "best_epoch": int(best_epoch),
            "epochs_ran": ran,
            "state": state,
            "final_state": final_state,
            "best_model_state": {k: v.detach().clone()
                                 for k, v in state.model.state_dict().items()}
            if found else None,
        }


def get_runner(engine: TrainEngine, state: TrainState, train_images,
               val_images, batch_size: int,
               placement: Optional[Placement] = None) -> FusedRunner:
    """The cached runner of this shape and placement, or a new one
    (cached)."""
    key = runner_key(engine, state, train_images, val_images, batch_size,
                     placement)
    runner = RUNNERS.get(key)
    if runner is None:
        runner = FusedRunner(engine, state, train_images.shape[0],
                             val_images.shape[0], placement=placement)
        RUNNERS[key] = runner
    return runner


def run_training_fused(engine: TrainEngine, state: TrainState,
                       train_images, train_masks, val_images, val_masks,
                       batch_size: int, num_epochs: int, lr0: float,
                       generator: torch.Generator,
                       scheduler_params: Optional[Dict] = None,
                       es_patience: int = 7, es_min_delta: float = 0.001,
                       mesh=None, axis: str = "data",
                       spatial_axis: Optional[str] = None) -> Dict:
    """Run a full training loop as replayed graphs.

    ``state``: the starting ``TrainState`` (its optimizer one of
    ``make_optimizer``'s); the images and masks (N, 1, S, S) tensors on
    the engine's device; ``generator``: the generator of the epochs'
    permutations (the stepwise loop's: ``train_model`` seeds it at
    seed + 1). ``scheduler_params``: None (constant LR) or dict(factor,
    patience, threshold, min_lr) — ReduceLROnPlateau mode='max' semantics.
    ``mesh`` (default: the mesh entered with ``with mesh:``, if any): the
    run is data-parallel over its axis ``axis`` (and with
    ``spatial_axis`` on row bands over that axis); every rank passes the
    whole set, the same ``state`` and an equally seeded ``generator``,
    and gets the same results (module docstring).

    Returns dict: train_history/val_history (one dict of METRIC_KEYS per
    epoch run), lr_history, best_iou, best_found, best_epoch, epochs_ran,
    state (``state`` itself, holding the best weights where an epoch
    improved, else the final ones, and the final optimizer state),
    final_state (the final weights, ``state`` when no epoch improved),
    best_model_state (a ``state_dict`` copy of the best weights, or
    None).
    """
    mesh = mesh if mesh is not None else current_mesh()
    placement = None if mesh is None else Placement(mesh, axis, spatial_axis)
    runner = get_runner(engine, state, train_images, val_images, batch_size,
                        placement)
    return runner.run(
        state, DeviceDataLoader(train_images, train_masks, batch_size,
                                shuffle=True),
        DeviceDataLoader(val_images, val_masks, batch_size, shuffle=False),
        generator, num_epochs, lr0, scheduler_params, es_patience,
        es_min_delta)
