"""Fold-parallel cross-validation training (port of
``segtpu/eval/fold_parallel.py``).

The reference trains its K folds one after another (cross_validation.py:
77-124), each a fresh model through ``train_model``. The folds are
independent, so all K advance together, one epoch per round, with the
JAX package's two strategies and the same per-fold semantics:

- ``stream`` (default): each live fold's epoch (shuffle, training epoch,
  validation pass; ``TrainEngine.run_fold_epoch_async``) is enqueued
  back to back with no host fetch, for a window of h epochs, and the
  window's K×h metric totals come back in ONE device→host copy
  (``fetch_count`` counts them). The name is the JAX package's: it means
  asynchronous dispatch with one fetch per window, not CUDA streams. h is
  the controllers' no-event horizon (``safe_horizon``) capped by
  ``auto_pipeline_window``, so the window changes no decision. The
  optimizer updates the weights in place, so each fold's weights after
  each window epoch are snapshotted on the device (a clone) for the
  best-weights restore; the window's budget counts those copies.
  ``devices=[...]`` places fold k on ``devices[k % len(devices)]``.
- ``vmap``: the K folds stacked on a leading axis
  (``TrainEngine.run_fold_epochs``): each step is one ``torch.func.vmap``
  of the forward and backward over the fold axis (per-fold weights make
  every convolution a grouped one) and a functional optimizer update;
  each fold's validation pass runs unbatched on a real model holding its
  weights, so the attention gates run the gate kernel. Folds of equal
  sizes only (``cv_train_folds_parallel`` groups them); a fold that stops
  early keeps riding the stack and its extra epochs are discarded.

Per fold, as sequential ``train_model``: the init from
``torch.Generator().manual_seed(seed_k)``, ``seed_k = seed + 1000·k``,
the shuffle from ``torch.Generator(device).manual_seed(seed_k + 1)``,
``CellAugmenter(seed=seed_k)``, the foreground-prior final bias where
``train_model`` sets it, the encoder checkpoint laid over the init, and
the host-side plateau scheduler, early stopping and best-weights
tracking between epochs (train.py:115-244).
"""

from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.data.augment import CellAugmenter
from segtpu_torch.models.torch_convert import (load_pretrained,
                                               resolve_encoder_checkpoint)
from segtpu_torch.train.engine import (METRIC_KEYS, TrainEngine, TrainState,
                                       auto_pipeline_window, get_engine,
                                       tree_bytes)
from segtpu_torch.train.loop import (BCE_FAMILY_LOSSES, _materialize,
                                     _snapshot)
from segtpu_torch.train.optim import EarlyStopping, ReduceLROnPlateau

_FETCHES = 0


def fetch_count() -> int:
    """Device→host copies of metric totals made by this module."""
    return _FETCHES


def reset_fetch_count() -> None:
    global _FETCHES
    _FETCHES = 0


def _fetch(totals: Sequence[torch.Tensor]) -> torch.Tensor:
    """The one device→host copy of a window (or of a ``vmap`` epoch): the
    totals stacked, on the CPU. On CUDA it is the window's only
    synchronisation, so it is let through ``torch.cuda``'s sync debug
    mode."""
    global _FETCHES
    _FETCHES += 1
    stacked = torch.stack([t.to(totals[0].device) for t in totals])
    if not stacked.is_cuda:
        return stacked
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return stacked.cpu()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _fold_bias_prior(state: TrainState, masks: torch.Tensor) -> TrainState:
    """The fold's foreground-prior final bias, as ``train_model`` sets it
    from scratch (``train/loop.py::_auto_final_bias``): logit of the
    training masks' mean, clipped to [1e-4, 1 − 1e-4], computed on the
    device in float64 (no host fetch)."""
    conv = getattr(state.model, "conv_final", None)
    if conv is None:
        return state
    p = masks.mean().double().clamp(1e-4, 1.0 - 1e-4)
    with torch.no_grad():
        conv.bias.copy_(torch.log(p / (1.0 - p)).expand_as(conv.bias))
    return state


def _fold_engine(engine: TrainEngine, device: torch.device) -> TrainEngine:
    if device == engine.device:
        return engine
    other = copy.copy(engine)
    other.device = device
    return other


def train_folds_parallel(
        fold_arrays: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]],
        config: Dict, engine: Optional[TrainEngine] = None,
        seeds: Optional[Sequence[int]] = None, auto_bias: bool = True,
        strategy: str = "stream", devices: Optional[Sequence] = None, *,
        device="cuda") -> List[Dict]:
    """Train K independent folds together; one ``train_model``-schema
    result per fold (train_metrics, val_metrics, lr_history, best_iou,
    best_epoch, best_model_state, state, training_time,
    final_train_metrics, final_val_metrics).

    ``fold_arrays``: per fold (train images, train masks, val images, val
    masks), (N, 1, S, S) tensors as ``train_model`` materialises them.
    ``seeds``: per-fold seeds (default ``config.seed + 1000·k``).
    ``auto_bias=False`` leaves the foreground-prior bias out (forward
    selection's sequential path never sets it). ``strategy``: "stream" or
    "vmap" (config ``fold_parallel_strategy`` overrides it). ``devices``:
    torch devices, fold k on ``devices[k % len(devices)]`` (stream only).
    ``device``: the engine's device when ``engine`` is None (default
    ``cuda``; raises without it unless ``device='cpu'``)."""
    config = dict(config or {})
    k_folds = len(fold_arrays)
    num_epochs = int(config.get("num_epochs", 50))
    batch_size = int(config.get("batch_size", 2))
    lr0 = float(config.get("learning_rate", 1e-3))
    wd = float(config.get("weight_decay", 1e-5))
    base_seed = int(config.get("seed", 0))
    if seeds is None:
        seeds = [base_seed + 1000 * k for k in range(k_folds)]
    strategy = config.get("fold_parallel_strategy", strategy)
    if strategy not in ("stream", "vmap"):
        raise ValueError(f"unknown fold-parallel strategy {strategy!r}")
    if engine is None:
        engine = get_engine(config, device=device)
    fold_devs = [engine.device] * k_folds
    if devices and strategy == "stream":
        fold_devs = [resolve_device(devices[k % len(devices)])
                     for k in range(k_folds)]
    engines = [_fold_engine(engine, d) for d in fold_devs]
    arrays = [tuple(t.to(d) for t in f) for f, d in zip(fold_arrays,
                                                         fold_devs)]

    # ---- per-fold fresh init (+ the foreground-prior bias where
    # train_model sets it; + the encoder checkpoint laid over it)
    auto_bias = (auto_bias and "final_bias_prior" not in config
                 and engine.n_classes == 1
                 and config.get("loss_fn", "combo") in BCE_FAMILY_LOSSES)
    ckpt = resolve_encoder_checkpoint(config.get("encoder_checkpoint"),
                                      engine.backbone)
    states = []
    for k in range(k_folds):
        gen = torch.Generator().manual_seed(int(seeds[k]))
        if ckpt:
            model = load_pretrained(
                engines[k].build_model(), gen, ckpt,
                kind=config.get("checkpoint_kind", "torchvision"))
            st = TrainState(model, engines[k].make_optimizer(model, lr0, wd))
        else:
            st = engines[k].init_state(gen, lr0, wd)
            if auto_bias:
                st = _fold_bias_prior(st, arrays[k][1])
        states.append(st)

    # ---- host-side per-fold controllers, as the sequential path's
    # (CrossValidator.train_single_model: max mode, ×0.5, patience 3,
    # threshold 1e-4, min_lr 1e-6)
    schedulers = [ReduceLROnPlateau(
        initial_lr=lr0, mode="max", factor=0.5,
        patience=config.get("scheduler_patience", 3),
        threshold=config.get("scheduler_threshold", 1e-4),
        min_lr=1e-6) for _ in range(k_folds)]
    stoppers = [EarlyStopping(
        patience=config.get("early_stopping_patience", 7),
        min_delta=config.get("early_stopping_min_delta", 0.001))
        for _ in range(k_folds)]
    lrs = np.full(k_folds, lr0, np.float64)
    # linear warmup (epoch e in 1..W at lr0·e/W; schedulers engage after
    # it) and cosine decay, as train_model
    warmup = int(config.get("warmup_epochs", 0))
    schedule = str(config.get("lr_schedule", "plateau")).lower()
    if schedule not in ("plateau", "cosine"):
        raise ValueError(
            f"Unknown lr_schedule '{schedule}' (plateau|cosine)")
    cmin = float(config.get("min_lr", 1e-6))
    cspan = max(1, num_epochs - warmup)

    def cos_lr(e: int) -> float:
        return cmin + 0.5 * (lr0 - cmin) * (
            1.0 + math.cos(math.pi * (e - warmup) / cspan))

    active = np.ones(k_folds, bool)
    tr_hist: List[List[Dict]] = [[] for _ in range(k_folds)]
    va_hist: List[List[Dict]] = [[] for _ in range(k_folds)]
    lr_hist: List[List[float]] = [[] for _ in range(k_folds)]
    best_iou = np.zeros(k_folds)
    best_epoch = np.zeros(k_folds, int)
    best_found = np.zeros(k_folds, bool)
    ns = [a[0].shape[0] for a in arrays]
    nvs = [a[2].shape[0] for a in arrays]
    # per-fold shuffle chains: train_model seeds its generator at seed+1
    gens = [torch.Generator(d).manual_seed(int(s) + 1)
            for s, d in zip(seeds, fold_devs)]

    def controller_step(k: int, epoch: int, tt, vt, improved,
                        ran_lr=None) -> None:
        tm = dict(zip(METRIC_KEYS, (tt / ns[k]).tolist()))
        vm = dict(zip(METRIC_KEYS, (vt / nvs[k]).tolist()))
        tr_hist[k].append(tm)
        va_hist[k].append(vm)
        if schedule == "cosine":
            # the LR the epoch ran at (train_model's history)
            lr_hist[k].append(float(ran_lr if ran_lr is not None
                                    else lrs[k]))
        else:
            if epoch + 1 > warmup:
                lrs[k] = schedulers[k].step(vm["iou"])
            lr_hist[k].append(float(lrs[k]))
        if vm["iou"] > best_iou[k]:
            best_iou[k] = vm["iou"]
            best_epoch[k] = epoch
            improved[k] = True
            best_found[k] = True
        if stoppers[k].step(vm["iou"]):
            active[k] = False

    t0 = time.time()
    if strategy == "vmap":
        if len(set(ns)) != 1 or len(set(nvs)) != 1:
            raise ValueError("the vmap strategy needs folds of equal sizes; "
                             f"got train {ns}, val {nvs} (group them, as "
                             "cv_train_folds_parallel does)")
        stack = engine.stack_folds(states, wd)
        del states
        tr_i, tr_m, va_i, va_m = (torch.stack([a[j] for a in arrays])
                                  for j in range(4))
        best = stack.snapshot()
        for epoch in range(num_epochs):
            if epoch < warmup:
                lrs[:] = lr0 * (epoch + 1) / warmup
            elif schedule == "cosine":
                lrs[:] = cos_lr(epoch)
            stack, ttot, vtot = engine.run_fold_epochs(
                stack, tr_i, tr_m, va_i, va_m, lrs, gens, batch_size)
            ttot, vtot = _fetch([ttot, vtot])    # one copy for all folds
            improved = np.zeros(k_folds, bool)
            for k in range(k_folds):
                if active[k]:
                    controller_step(k, epoch, ttot[k], vtot[k], improved)
            if improved.any():
                cur = {**stack.params, **stack.buffers}
                for k in np.nonzero(improved)[0]:
                    for name, t in best.items():
                        t[k].copy_(cur[name][k])
            if not active.any():
                break
        states = [engine.fold_state(stack, k, float(lrs[k]))
                  for k in range(k_folds)]
        best_states = [{n: t.clone() for n, t in
                        stack.fold_state_dict(k, best).items()}
                       if best_found[k] else None for k in range(k_folds)]
    else:
        best_states: List[Optional[Dict]] = [None] * k_folds
        # the window: each in-flight epoch holds every live fold's
        # weights snapshot and its shuffled view of the training data
        per_step_bytes = sum(tree_bytes(states[k].model, arrays[k][0],
                                        arrays[k][1])
                             for k in range(k_folds))
        pipeline = auto_pipeline_window(config, per_step_bytes)
        epoch = 0
        while epoch < num_epochs and active.any():
            live = np.nonzero(active)[0]
            if epoch < warmup:
                h = 1
                lrs[live] = lr0 * (epoch + 1) / warmup
            elif schedule == "cosine":
                # no scheduler events to predict: full window depth
                h = min([pipeline, num_epochs - epoch]
                        + [stoppers[k].safe_horizon() for k in live])
            else:
                h = min([pipeline, num_epochs - epoch]
                        + [schedulers[k].safe_horizon() for k in live]
                        + [stoppers[k].safe_horizon() for k in live])
            pending, snaps, step_lrs = dispatch_window(
                engines, states, arrays, gens, live, h, lrs, batch_size,
                lr_at=(lambda e: cos_lr(e) if schedule == "cosine"
                       and e >= warmup else None), epoch=epoch)
            flat = [t for pj in pending for k in live for t in pj[k]]
            fetched = iter(_fetch(flat))         # one copy for the window
            for j, sj in enumerate(snaps):
                improved = np.zeros(k_folds, bool)
                for k in live:
                    tt, vt = next(fetched), next(fetched)
                    if active[k]:    # a stop lands on a window's last epoch
                        controller_step(k, epoch, tt, vt, improved,
                                        ran_lr=step_lrs[j])
                for k in np.nonzero(improved)[0]:
                    best_states[k] = sj[k]
                epoch += 1
    elapsed = time.time() - t0

    results = []
    for k in range(k_folds):
        st = states[k]
        bp = best_states[k] if best_found[k] else None
        if bp is not None:
            st.model.load_state_dict(bp)
        results.append({
            "train_metrics": tr_hist[k],
            "val_metrics": va_hist[k],
            "lr_history": lr_hist[k],
            "best_iou": float(best_iou[k]),
            "best_epoch": int(best_epoch[k]),
            "best_model_state": bp,
            "state": st,
            "training_time": elapsed / k_folds,  # amortised over the folds
            "final_train_metrics": tr_hist[k][-1] if tr_hist[k] else {},
            "final_val_metrics": va_hist[k][-1] if va_hist[k] else {},
        })
    return results


def dispatch_window(engines, states, arrays, gens, live, h: int, lrs,
                    batch_size: int, lr_at=lambda e: None, epoch: int = 0):
    """Enqueue ``h`` epochs of every live fold back to back, with no host
    fetch (the ``stream`` strategy's window): returns, per window step,
    {fold: (train totals, val totals)} as device tensors, {fold: its
    weights snapshot after the step} and the LR the step ran at.
    ``lr_at(e)``: the LR of epoch ``e`` where a schedule fixes it ahead
    (cosine), else None (the folds' current ``lrs``)."""
    pending, snaps, step_lrs = [], [], []
    for i in range(h):
        ahead = lr_at(epoch + i)
        if ahead is not None:
            lrs[live] = ahead
        step_lrs.append(float(lrs[live[0]]))
        pj, sj = {}, {}
        for k in live:
            states[k], tt, vt = engines[k].run_fold_epoch_async(
                states[k], *arrays[k], float(lrs[k]), gens[k], batch_size)
            pj[k] = (tt, vt)
            # the optimizer updates the weights in place: a clone on the
            # device is the snapshot
            sj[k] = _snapshot(states[k].model)
        pending.append(pj)
        snaps.append(sj)
    return pending, snaps, step_lrs


def cv_train_folds_parallel(canonical_imgs, canonical_masks,
                            cv_folds: Sequence[Tuple[Sequence[int],
                                                     Sequence[int]]],
                            config: Dict, augmentations_per_image: int = 0,
                            engine: Optional[TrainEngine] = None,
                            fold_ids: Optional[Sequence[int]] = None, *,
                            device="cuda") -> List[Dict]:
    """CV over canonical uint8 frames (N, S, S) with the folds trained in
    parallel: per fold the ``train_model`` front half (augment with
    ``CellAugmenter(seed=seed_k)``, materialise on ``device``), then
    ``train_folds_parallel``. Under ``stream`` all folds train in one
    run whatever their sizes; under ``vmap`` (config
    ``fold_parallel_strategy``) folds of equal train/val sizes are
    grouped into stacked runs.

    ``fold_ids``: the folds' original indices (their seeds) when
    ``cv_folds`` is a subset of a longer fold list (resumed runs).
    Returns ``train_model``-schema results in fold order."""
    config = dict(config or {})
    dev = resolve_device(device)
    base_seed = int(config.get("seed", 0))
    fold_ids = list(range(len(cv_folds))) if fold_ids is None \
        else list(fold_ids)
    n_classes = int(config.get("n_classes", 1))
    groups: Dict = {}
    prepared = []
    for k, (tr_idx, va_idx) in enumerate(cv_folds):
        seed = base_seed + 1000 * fold_ids[k]
        ci = canonical_imgs[list(tr_idx)]
        cm = canonical_masks[list(tr_idx)]
        if augmentations_per_image > 0:
            # n_classes > 1: label-safe augmentation, as train_model's
            ci, cm = CellAugmenter(augmentations_per_image, seed=seed,
                                   n_classes=n_classes, device=dev
                                   ).augment_training_data(ci, cm)
        tr = _materialize(ci, cm, n_classes, device=dev)
        va = _materialize(canonical_imgs[list(va_idx)],
                          canonical_masks[list(va_idx)], n_classes,
                          device=dev)
        prepared.append((tr[0], tr[1], va[0], va[1], seed))
        groups.setdefault((tr[0].shape[0], va[0].shape[0]), []).append(k)

    if config.get("fold_parallel_strategy", "stream") == "stream":
        groups = {None: list(range(len(cv_folds)))}

    results: List[Optional[Dict]] = [None] * len(cv_folds)
    for group in groups.values():
        out = train_folds_parallel(
            [prepared[k][:4] for k in group], config, engine=engine,
            seeds=[prepared[k][4] for k in group], device=dev)
        for k, res in zip(group, out):
            results[k] = res
    return results
