"""The training engine (port of ``segtpu/train/engine.py``).

A train step is the reference's (train.py:17-68): a train-mode forward,
the loss, backward, one optimizer update; its metrics come from the
pre-update train-mode logits. Evaluation runs the model in eval mode, so
the running BatchNorm statistics are used and the port's kernels run
(the attention gate, the upsample + concat). An epoch is a plain Python
loop over the loader's batches; its metrics are sample-weighted totals
kept on the device and fetched once per epoch. (The JAX package scans an
epoch as one program and buckets its length, only to spare XLA
recompiles; nothing here compiles.)

``config["dtype"] == "bfloat16"`` means what it means in flax: parameters
and optimizer state stay float32, the forward computes in bf16
(``torch.autocast``); the loss and the metrics take the logits in
float32. ``remat="full"`` re-runs the forward in backward
(``torch.utils.checkpoint``) with the BatchNorm running statistics held
still in the re-run, so a step updates them once, as ``jax.checkpoint``.

The model's weights live in a ``TrainState`` (the model and its
optimizer), not in the engine: one engine can serve every fold of a
sweep.

Fold-parallel training (``segtpu_torch/eval/fold_parallel.py``) has two
building blocks here, as in the JAX package: ``run_fold_epoch_async``,
one fold's training epoch and validation pass returned as device tensors
with no host fetch, and ``run_fold_epochs``, K folds stacked on a leading
axis (``StackedFolds``) and trained as one stream of ``torch.func.vmap``
ops per step, with a functional form of the optimizer
(``train/optim.py::functional_step``). Its validation passes run per fold,
unbatched, on a real model holding that fold's weights, so they run the
port's kernels as any evaluation does.
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call, grad_and_value, vmap
from torch.utils.checkpoint import checkpoint

from segtpu_torch import resolve_device
from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.losses import get_loss_function
from segtpu_torch.metrics import calculate_metrics
from segtpu_torch.models.backbones import frozen_running_stats
from segtpu_torch.models.unet import UNetWithBackbone
from segtpu_torch.parallel.data_parallel import local_batch, synced
from segtpu_torch.train.optim import (functional_init, functional_step,
                                      load_functional_state, make_optimizer,
                                      set_learning_rate)

METRIC_KEYS = ("precision", "recall", "f1", "iou", "accuracy", "loss")

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _at_least_f32(logits: torch.Tensor) -> torch.Tensor:
    """Logits as the loss and the metrics take them: bf16 → float32."""
    return logits.float() if logits.dtype == torch.bfloat16 else logits


def tree_bytes(*trees) -> int:
    """Total byte size of the tensors in the given trees: tensors,
    modules (their ``state_dict``), dicts, lists and tuples of them."""
    total = 0
    for t in trees:
        if isinstance(t, torch.nn.Module):
            t = t.state_dict()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tree_bytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += tree_bytes(*t)
    return total


def auto_pipeline_window(config: Dict, per_epoch_bytes: int,
                         cap: int = 4) -> int:
    """The epoch-pipelining window: ``pipeline_epochs`` where the config
    sets it, else as many epochs as fit ``pipeline_hbm_budget`` bytes
    (default 4e9, the JAX package's default) at ``per_epoch_bytes`` each,
    at most ``cap``, at least 1. An epoch in flight holds a snapshot of
    every live fold's weights and its shuffled view of the data until the
    window's fetch."""
    explicit = config.get("pipeline_epochs")
    if explicit is not None:
        return max(1, int(explicit))
    budget = float(config.get("pipeline_hbm_budget", 4e9))
    return max(1, min(cap, int(budget // max(per_epoch_bytes, 1))))


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics, float32) and its
    optimizer (None for a state restored only to predict)."""
    model: UNetWithBackbone
    optimizer: Optional[torch.optim.Optimizer] = None


@dataclass
class StackedFolds:
    """K folds' weights on a leading fold axis: ``params`` and ``buffers``
    (every buffer, the BatchNorms' non-persistent scratch too, so that
    ``vmap`` keeps each fold's statistics its own) as
    ``torch.func.stack_module_state`` gives them, the functional optimizer
    state ``opt`` after ``step`` updates, ``template`` (a module of the
    architecture, run through ``functional_call``) and ``eval_model`` (a
    real model that takes one fold's weights for its validation pass)."""
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: Dict[str, Dict[str, torch.Tensor]]
    template: torch.nn.Module
    weight_decay: float
    step: int = 0
    eval_model: Optional[torch.nn.Module] = field(default=None, repr=False)

    def fold_state_dict(self, k: int,
                        weights: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Fold ``k``'s ``state_dict`` (views into the stack, or into
        ``weights``, a ``snapshot``)."""
        both = weights if weights is not None else {**self.params,
                                                    **self.buffers}
        return {name: both[name][k]
                for name in self.template.state_dict().keys()}

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """A device-side copy of every fold's parameters and buffers."""
        return {n: t.detach().clone()
                for n, t in {**self.params, **self.buffers}.items()}


class TrainEngine:
    """Train and eval steps and epochs for one (model configuration, loss,
    optimizer) triple on one device."""

    def __init__(self, model_kwargs: Dict, loss_fn: Callable,
                 multiclass: bool = False, remat: str = "none",
                 optimizer: str = "adam",
                 optimizer_kwargs: Optional[Dict] = None,
                 compute_dtype=torch.float32, *, device="cuda"):
        if remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full'; got {remat!r}")
        self.device = resolve_device(device)
        self.model_kwargs = dict(model_kwargs)
        self.n_classes = int(self.model_kwargs.get("n_classes", 1))
        self.backbone = self.model_kwargs.get("backbone", "resnet34")
        self.loss_fn = loss_fn
        self.multiclass = multiclass
        self.remat = remat
        self.compute_dtype = compute_dtype
        if multiclass:
            from segtpu_torch.losses.multiclass import \
                calculate_metrics_multiclass
            self._act = lambda lg: torch.softmax(lg, dim=1)
            self._metrics = calculate_metrics_multiclass
        else:
            self._act = torch.sigmoid
            self._metrics = calculate_metrics
        self.optimizer_name = optimizer
        self.optimizer_kwargs = dict(optimizer_kwargs or {})

    # ------------------------------------------------------------ init

    def build_model(self) -> UNetWithBackbone:
        """The model on the device, torch's default initialisation (a
        state is made from it by ``init_state`` or ``state_from``)."""
        return UNetWithBackbone(**self.model_kwargs, device=self.device)

    def make_optimizer(self, model, learning_rate: float,
                       weight_decay: float):
        return make_optimizer(self.optimizer_name, model.parameters(),
                              learning_rate, weight_decay,
                              **self.optimizer_kwargs)

    def init_state(self, generator: torch.Generator, learning_rate: float,
                   weight_decay: float) -> TrainState:
        """A fresh model, its weights drawn as the JAX package's are
        (``UNetWithBackbone.reset_parameters``) from ``generator`` (a CPU
        generator), and a fresh optimizer."""
        model = self.build_model().reset_parameters(generator)
        return TrainState(model, self.make_optimizer(model, learning_rate,
                                                     weight_decay))

    def state_from(self, state_dict: Dict[str, torch.Tensor],
                   learning_rate: float, weight_decay: float) -> TrainState:
        """A model holding ``state_dict`` (reference key names, strict)
        with a fresh optimizer."""
        model = self.build_model()
        model.load_state_dict(state_dict, strict=True)
        return TrainState(model, self.make_optimizer(model, learning_rate,
                                                     weight_decay))

    # ------------------------------------------------------------ steps

    def autocast(self):
        """The compute-dtype context of every forward: autocast to bf16
        for ``dtype="bfloat16"``, else nothing."""
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    def _forward_train(self, model, images):
        if self.remat == "full":
            return checkpoint(
                model, images, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    frozen_running_stats(model)))
        return model(images)

    def _metric_vec(self, logits, masks, loss) -> torch.Tensor:
        """The metrics and the loss, float32 (float64 for a float64
        loss)."""
        with torch.no_grad():
            m = self._metrics(self._act(logits.detach()), masks)
            m["loss"] = loss.detach()
            dt = torch.promote_types(loss.dtype, torch.float32)
            return torch.stack([m[k].to(dt) for k in METRIC_KEYS])

    def _micro_step(self, model, images, masks, scale: float, sync=None
                    ) -> torch.Tensor:
        """Forward, loss, backward (gradients added, scaled by
        ``scale``); returns the metric vector of the pre-update logits.
        Under data parallelism (``sync``, ``parallel/data_parallel.py``)
        the BatchNorms take the global batch's statistics, the layers on
        row bands their halo rows, and the loss and the metrics the
        gathered global batch."""
        with synced(model, sync):
            with self.autocast():
                logits = _at_least_f32(self._forward_train(model, images))
            if sync is not None:
                logits, masks = sync.gather(logits), sync.gather(masks)
            loss = self.loss_fn(logits, masks)
            (loss * scale if scale != 1.0 else loss).backward()
        return self._metric_vec(logits, masks, loss)

    def _train_step_vec(self, state: TrainState, images, masks
                        ) -> torch.Tensor:
        model, opt = state.model, state.optimizer
        images, masks, sync = local_batch(images, masks)
        model.train()
        opt.zero_grad(set_to_none=True)
        vec = self._micro_step(model, images, masks, 1.0, sync)
        if sync is not None:
            sync.reduce_gradients(model.parameters())
        opt.step()
        return vec

    def train_step(self, state: TrainState, images, masks,
                   lr: Optional[float] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on a batch (B, 1, S, S), plain or sharded
        (``parallel.shard_batch``: its rows over a mesh axis, and on a
        ``("data", "spatial")`` mesh its images' rows in bands too);
        metrics as 0-d tensors."""
        if lr is not None:
            set_learning_rate(state.optimizer, lr)
        vec = self._train_step_vec(state, images, masks)
        return state, dict(zip(METRIC_KEYS, vec))

    def train_step_accum(self, state: TrainState, images, masks,
                         lr: Optional[float] = None
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Gradient accumulation: images/masks (A, b, 1, S, S), A
        micro-batches in sequence folded into one update. Each micro-batch
        normalises by its own BatchNorm statistics and moves the running
        statistics in turn; the gradients and the metrics are averaged
        over A. Sharded, the micro-batches' rows are split over the ranks
        (``shard_batch(..., dim=1)``; their images' rows, dim 3, may be in
        bands too) and the gradients summed over them once, before the
        update."""
        if lr is not None:
            set_learning_rate(state.optimizer, lr)
        model, opt = state.model, state.optimizer
        images, masks, sync = local_batch(images, masks)
        model.train()
        opt.zero_grad(set_to_none=True)
        a = images.shape[0]
        total = sum(self._micro_step(model, images[i], masks[i], 1.0 / a,
                                     sync)
                    for i in range(a))
        if sync is not None:
            sync.reduce_gradients(model.parameters())
        opt.step()
        return state, dict(zip(METRIC_KEYS, total / a))

    def _eval_step_vec(self, state: TrainState, images, masks
                       ) -> torch.Tensor:
        model = state.model
        images, masks, sync = local_batch(images, masks)
        model.eval()
        with torch.no_grad(), self.autocast(), synced(model, sync):
            logits = _at_least_f32(model(images))
        if sync is not None:
            logits, masks = sync.gather(logits), sync.gather(masks)
        return self._metric_vec(logits, masks, self.loss_fn(logits, masks))

    # ------------------------------------------------------------ epochs

    def _epoch_totals(self, step, loader, generator=None) -> torch.Tensor:
        """Sample-weighted metric totals (6,) of ``step`` over the
        loader's batches (plain, or sharded by ``parallel.shard_loader``:
        weighted by their global rows), on the device."""
        (fi, fm), rem = loader.batches(generator)
        totals = torch.zeros(len(METRIC_KEYS), device=loader.device)
        for x, y in zip(fi, fm):
            totals += step(x, y) * x.shape[0]
        if rem is not None:
            totals += step(*rem) * rem[0].shape[0]
        return totals

    def _train_totals(self, state, loader, lr, generator):
        set_learning_rate(state.optimizer, lr)
        return self._epoch_totals(
            lambda i, m: self._train_step_vec(state, i, m), loader,
            generator)

    def _eval_totals(self, state, loader):
        return self._epoch_totals(
            lambda i, m: self._eval_step_vec(state, i, m), loader)

    def run_train_epoch(self, state: TrainState, loader, lr: float,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[TrainState, Dict[str, float]]:
        """One training epoch (reference: train.py:17-68);
        sample-weighted epoch metrics as floats."""
        vals = self._train_totals(state, loader, lr, generator).cpu()
        vals = vals / loader.n
        return state, dict(zip(METRIC_KEYS, vals.tolist()))

    def run_eval_epoch(self, state: TrainState, loader) -> Dict[str, float]:
        """Evaluation epoch (reference: train.py:71-112)."""
        vals = self._eval_totals(state, loader).cpu() / loader.n
        return dict(zip(METRIC_KEYS, vals.tolist()))

    def run_train_and_eval_epoch_async(
            self, state: TrainState, train_loader, val_loader, lr: float,
            generator: Optional[torch.Generator] = None):
        """A training epoch and a validation pass, enqueued with no host
        fetch: (state, train totals (6,), val totals (6,)) as device
        tensors, sample-weighted sums (divide by the loaders' ``n``)."""
        tt = self._train_totals(state, train_loader, lr, generator)
        vt = self._eval_totals(state, val_loader)
        return state, tt, vt

    def run_train_and_eval_epoch(self, state: TrainState, train_loader,
                                 val_loader, lr: float,
                                 generator: Optional[torch.Generator] = None):
        """A training epoch and a validation pass with one host fetch of
        both metric totals."""
        state, tt, vt = self.run_train_and_eval_epoch_async(
            state, train_loader, val_loader, lr, generator)
        tv, vv = torch.stack([tt, vt]).cpu()
        return (state, dict(zip(METRIC_KEYS, (tv / train_loader.n).tolist())),
                dict(zip(METRIC_KEYS, (vv / val_loader.n).tolist())))

    # ------------------------------------------------------ fold-parallel

    def run_fold_epoch_async(self, state: TrainState, ti, tm, vi, vm,
                             lr: float, generator: torch.Generator,
                             batch_size: int):
        """One fold's epoch on its tensors (train (N, 1, S, S), val
        (Nv, 1, S, S)): the shuffle from ``generator``, the training
        epoch and the validation pass, as ``train_model`` runs them;
        returns (state, train totals (6,), val totals (6,)) as device
        tensors, unfetched, so that a caller can enqueue K folds' epochs
        back to back and fetch them all at once (the ``stream`` strategy)."""
        return self.run_train_and_eval_epoch_async(
            state, DeviceDataLoader(ti, tm, batch_size, shuffle=True),
            DeviceDataLoader(vi, vm, batch_size, shuffle=False), lr,
            generator)

    def stack_folds(self, states: Sequence[TrainState],
                    weight_decay: float) -> StackedFolds:
        """K fresh states → ``StackedFolds`` (copies of their weights,
        fresh optimizer state, a copy of the first model as the template);
        the states are left as they were."""
        models = [s.model for s in states]
        params, buffers = torch.func.stack_module_state(models)
        # fresh row-major copies: stacked channels_last weights (strides
        # of size-1 dimensions included, which ``.contiguous()`` leaves
        # alone) give wrong weight gradients under vmap at a batch of one,
        # with no error (torch 2.13, on the CPU)
        params = {n: p.detach().clone(memory_format=torch.contiguous_format)
                  for n, p in params.items()}
        return StackedFolds(params, buffers,
                            functional_init(self.optimizer_name, params),
                            copy.deepcopy(models[0]).train(),
                            float(weight_decay))

    def load_fold(self, stack: StackedFolds, k: int,
                  model: Optional[torch.nn.Module] = None
                  ) -> torch.nn.Module:
        """Fold ``k``'s weights copied into ``model`` (default: a new
        one). The copy bumps every tensor's version, so an attention
        gate's cached BatchNorm fold is refolded at its next call."""
        model = model if model is not None else self.build_model()
        model.load_state_dict(stack.fold_state_dict(k))
        return model

    def fold_state(self, stack: StackedFolds, k: int, lr: float
                   ) -> TrainState:
        """Fold ``k`` as a ``TrainState`` of its own: a new model with its
        weights, and an optimizer holding its moments."""
        model = self.load_fold(stack, k)
        opt = self.make_optimizer(model, lr, stack.weight_decay)
        load_functional_state(opt, model, stack.opt, k, stack.step)
        return TrainState(model, opt)

    def _stacked_step(self, stack: StackedFolds, images, masks, lrs
                      ) -> torch.Tensor:
        """One update of every fold: images/masks (K, B, 1, S, S), lrs
        (K,); returns the metric vectors (K, 6) of the pre-update
        train-mode logits. The forward and backward are ``vmap`` over the
        fold axis of ``grad_and_value``; the BatchNorms update each fold's
        running statistics in place in ``stack.buffers``."""
        template = stack.template

        def loss_of(params, buffers, x, y):
            with self.autocast():
                logits = _at_least_f32(functional_call(
                    template, {**params, **buffers}, (x,)))
            loss = self.loss_fn(logits, y)
            return loss, self._metric_vec(logits, y, loss)

        with warnings.catch_warnings():
            # BatchNorm's running-statistics update (``lerp_``) has no
            # batching rule and runs once per fold: slower, not different
            warnings.filterwarnings("ignore", ".*batching rule.*")
            grads, (_, vec) = vmap(grad_and_value(loss_of, has_aux=True))(
                stack.params, stack.buffers, images, masks)
        stack.step += 1
        functional_step(self.optimizer_name, stack.params, grads, stack.opt,
                        lrs, stack.weight_decay, stack.step,
                        **self.optimizer_kwargs)
        return vec

    def run_fold_epochs(self, stack: StackedFolds, tr_i, tr_m, va_i, va_m,
                        lrs, generators: Sequence[torch.Generator],
                        batch_size: int):
        """Advance K stacked folds by one epoch each (the ``vmap``
        strategy): ``tr_i``/``tr_m`` (K, N, 1, S, S), ``va_i``/``va_m``
        (K, Nv, 1, S, S), ``lrs`` (K,), one shuffle generator per fold (the
        same permutations as ``run_fold_epoch_async``). Each step updates
        all K folds; each fold's validation pass then runs on
        ``stack.eval_model`` holding its weights. Returns (stack, train
        totals (K, 6), val totals (K, 6)) as device tensors, unfetched.
        ``remat`` is not applied here (it changes memory, not numbers)."""
        k = len(generators)
        b = int(batch_size)
        lrs = torch.as_tensor(lrs, dtype=torch.float64).to(tr_i.device)
        parts = [DeviceDataLoader(tr_i[f], tr_m[f], b).batches(generators[f])
                 for f in range(k)]
        fulls, rem = zip(*parts)
        fi = torch.stack([f[0] for f in fulls])
        fm = torch.stack([f[1] for f in fulls])
        totals = torch.zeros(k, len(METRIC_KEYS), device=tr_i.device)
        for i in range(fi.shape[1]):
            totals += self._stacked_step(stack, fi[:, i], fm[:, i], lrs) * b
        if rem[0] is not None:
            ri = torch.stack([r[0] for r in rem])
            rm = torch.stack([r[1] for r in rem])
            totals += self._stacked_step(stack, ri, rm, lrs) * ri.shape[1]
        if stack.eval_model is None:
            stack.eval_model = self.build_model()
        vt = torch.stack([
            self._eval_totals(
                TrainState(self.load_fold(stack, f, stack.eval_model)),
                DeviceDataLoader(va_i[f], va_m[f], b, shuffle=False))
            for f in range(k)])
        return stack, totals, vt


_OPTIMIZER_KW = ("momentum", "nesterov", "b1", "b2", "adam_eps")


def _optimizer_spec(config: Dict) -> Tuple[str, Dict]:
    """(name, kwargs) of the optimizer config names."""
    name = str(config.get("optimizer", "adam")).lower()
    kw = {}
    for k in _OPTIMIZER_KW:
        if config.get(k) is not None:
            kw["eps" if k == "adam_eps" else k] = config[k]
    if name != "sgd":
        kw.pop("momentum", None)
        kw.pop("nesterov", None)
    return name, kw


def get_engine(config: Dict, criterion: Optional[Callable] = None, *,
               device="cuda") -> TrainEngine:
    """A new engine for config (reference key names: backbone,
    use_attention, n_classes, dtype, final_bias_prior, fuse, remat,
    fuse_gate, reparam_in_train, the loss keys, optimizer and its keys) on
    ``device``; ``criterion`` replaces the configured loss. The port's
    defaults: ``fuse="kernel"``, ``fuse_gate=True``. (The JAX package
    caches engines to share compiled programs; an engine here holds only
    its settings and a loss function, so none is cached.)"""
    dev = resolve_device(device)
    dtype = str(config.get("dtype", "float32"))
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_COMPUTE_DTYPES)}; "
                         f"got {dtype!r}")
    n_classes = int(config.get("n_classes", 1))
    model_kwargs = dict(backbone=config.get("backbone", "resnet34"),
                        use_attention=bool(config.get("use_attention", True)),
                        n_classes=n_classes,
                        final_bias_prior=config.get("final_bias_prior"),
                        fuse=str(config.get("fuse", "kernel")),
                        fuse_gate=bool(config.get("fuse_gate", True)),
                        reparam_in_train=bool(
                            config.get("reparam_in_train", False)))
    multiclass = n_classes > 1
    if criterion is None and multiclass:
        from segtpu_torch.losses.multiclass import get_multiclass_loss
        criterion = get_multiclass_loss(config)
    elif criterion is None:
        criterion = get_loss_function(config)
    opt_name, opt_kw = _optimizer_spec(config)
    return TrainEngine(model_kwargs, criterion, multiclass=multiclass,
                       remat=str(config.get("remat", "none")),
                       optimizer=opt_name, optimizer_kwargs=opt_kw,
                       compute_dtype=_COMPUTE_DTYPES[dtype], device=dev)
