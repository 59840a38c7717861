"""Greedy forward selection of augmentation strategies (port of
``segtpu/experiments/forward_selection.py``).

Reference parity: forward_selection_integration.py — 18 candidate
transforms (the port's on-device versions, ``segtpu_torch/data/augment.py``),
GroupKFold by base-image name with a data-leakage assert (:425-450),
per-candidate CV score with add-if-improvement ≥ threshold, selection
probability p=0.7 vs realistic production probabilities (:238-268),
5 augmented copies per image during evaluation (:319), short-circuit
training (15 epochs under quick_evaluation, :374), JSON history (:651-653).

Each fold trains on ``device`` (default ``cuda``; raises without it unless
``device='cpu'``) through the engine, a window of epochs enqueued with one
host fetch of their validation totals (the controllers' no-event horizon,
as the JAX package's). ``fold_parallel`` in the base config trains a
set's folds together (``eval/fold_parallel.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.data.augment import (AUGMENTATION_CANDIDATES,
                                       augment_batch, build_pipeline)
from segtpu_torch.data.discovery import load_original_data
from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.data.preprocess import load_canonical
from segtpu_torch.eval.folds import group_kfold_split
from segtpu_torch.experiments.common import save_results
from segtpu_torch.train.engine import METRIC_KEYS, get_engine
from segtpu_torch.train.loop import _materialize
from segtpu_torch.train.optim import EarlyStopping, ReduceLROnPlateau


class AugmentationSelector:
    """Forward selection over the 18-candidate augmentation library
    (forward_selection_integration.py:25-599)."""

    def __init__(self, base_config: Dict, data_dir: str,
                 improvement_threshold: float = 0.005,
                 max_augmentations: int = 8, cv_folds: int = 3,
                 quick_evaluation: bool = True, *, device="cuda"):
        self.device = resolve_device(device)
        self.base_config = base_config
        self.data_dir = data_dir
        self.improvement_threshold = improvement_threshold
        self.max_augmentations = max_augmentations
        self.cv_folds = cv_folds
        self.quick_evaluation = quick_evaluation

        self.augmentation_candidates = list(AUGMENTATION_CANDIDATES.keys())
        self._load_dataset_paths()
        self.selection_history: List[Dict] = []
        self._canonical = None

    # ------------------------------------------------------------ data

    def _load_dataset_paths(self):
        """Original pairs + base-name groups
        (forward_selection_integration.py:183-236)."""
        data = load_original_data(self.data_dir,
                                  self.base_config["image_type"],
                                  with_groups=True)
        self.image_paths = data["image_paths"]
        self.mask_paths = data["mask_paths"]
        self.base_names = data["base_names"]
        print(f"Found {len(set(self.base_names))} unique base images")
        if not self.image_paths:
            raise ValueError(
                f"No matching image-mask pairs found for image type "
                f"'{self.base_config['image_type']}'!")

    def _get_canonical(self):
        if self._canonical is None:
            self._canonical = load_canonical(
                self.image_paths, self.mask_paths,
                tuple(self.base_config["img_size"]),
                return_raw_shapes=True, device=self.device)
        return self._canonical

    # ------------------------------------------------------------ training

    def _fold_data(self, train_idx, val_idx, selected_augs: List[str],
                   verbose: bool = True):
        """One fold's canonical uint8 frames with the candidate set applied:
        the originals, then 5 augmented copies of each when any transform
        is selected (forward_selection_integration.py:319), on the
        device."""
        ci, cm, raw_hw = self._get_canonical()
        tr_i = torch.as_tensor(ci[train_idx]).to(self.device)
        tr_m = torch.as_tensor(cm[train_idx]).to(self.device)
        va_i, va_m = ci[val_idx], cm[val_idx]

        if selected_augs:
            pipeline = build_pipeline(selected_augs, for_selection=True)
            # raw-frame semantics: random_crop's 96² and downscale's factor
            # apply to the RAW image as in the reference
            # (forward_selection_integration.py:168-172 + dataset.py:50)
            gen = torch.Generator(self.device).manual_seed(
                int(self.base_config.get("seed", 42)))
            ai, am = augment_batch(tr_i, tr_m, gen, pipeline, copies=5,
                                   raw_hw=raw_hw[train_idx])
            tr_i = torch.cat([tr_i, ai])
            tr_m = torch.cat([tr_m, am])
            if verbose:
                print(f"      Training with {len(tr_i)} images "
                      f"({len(train_idx)} original + "
                      f"{len(tr_i)-len(train_idx)} augmented)")
        elif verbose:
            print(f"      Training with {len(tr_i)} original images "
                  f"(no augmentation)")
        return tr_i, tr_m, va_i, va_m

    def _train_and_evaluate_fold(self, train_idx, val_idx,
                                 selected_augs: List[str]) -> float:
        """One fold: augment (5 copies/img if any transform), train with
        early stopping, return best val IoU
        (forward_selection_integration.py:311-404)."""
        tr_i, tr_m, va_i, va_m = self._fold_data(train_idx, val_idx,
                                                 selected_augs)
        dev = self.device
        imgs, masks = _materialize(tr_i, tr_m, device=dev)
        vimgs, vmasks = _materialize(va_i, va_m, device=dev)
        bs = self.base_config["batch_size"]
        train_loader = DeviceDataLoader(imgs, masks, bs, shuffle=True)
        val_loader = DeviceDataLoader(vimgs, vmasks, bs, shuffle=False)

        engine = get_engine(self.base_config, device=dev)
        lr = self.base_config.get("learning_rate", 1e-3)
        state = engine.init_state(
            torch.Generator().manual_seed(int(self.base_config.get("seed",
                                                                   42))),
            lr, self.base_config.get("weight_decay", 1e-5))

        scheduler = ReduceLROnPlateau(lr, mode="max", factor=0.5, patience=3,
                                      threshold=0.01, min_lr=1e-6)
        early = EarlyStopping(patience=3 if self.quick_evaluation else 10,
                              min_delta=0.01)
        max_epochs = 15 if self.quick_evaluation else \
            self.base_config["num_epochs"]

        # a window of the controllers' provable no-event horizon, enqueued
        # back to back, and ONE fetch of its validation totals (identical
        # decisions to one fetch per epoch)
        iou_idx = METRIC_KEYS.index("iou")
        pipeline = max(1, int(self.base_config.get("pipeline_epochs", 4)))
        best_iou = 0.0
        gen = torch.Generator(dev).manual_seed(7)
        epoch = 0
        stopped = False
        while epoch < max_epochs and not stopped:
            h = min(pipeline, max_epochs - epoch, scheduler.safe_horizon(),
                    early.safe_horizon())
            window = []
            for _ in range(h):
                state, _tt, vt = engine.run_train_and_eval_epoch_async(
                    state, train_loader, val_loader, lr, gen)
                window.append(vt)
            for vvals in torch.stack(window).cpu():
                val_iou = float(vvals[iou_idx] / val_loader.n)
                lr = scheduler.step(val_iou)
                best_iou = max(best_iou, val_iou)
                epoch += 1
                if early.step(val_iou):
                    print(f"      Stopped at epoch {epoch}/{max_epochs} "
                          f"- Best IoU: {best_iou:.4f}")
                    stopped = True
                    break
            if epoch == max_epochs and not stopped:
                print(f"      Completed {epoch} epochs "
                      f"- Best IoU: {best_iou:.4f}")
        return best_iou

    def _evaluate_folds_parallel(self, folds, selected_augs: List[str]
                                 ) -> List[float]:
        """All CV folds trained together (``eval/fold_parallel.py``):
        ``stream`` takes the unequal GroupKFold sizes in one run, ``vmap``
        stacks folds per size group. Same per-fold protocol as the
        sequential path (15-epoch quick cap, threshold-0.01 plateau, early
        stop), the same init seed every fold and no foreground-prior bias;
        only the shuffle generator differs (seeded seed + 1)."""
        from segtpu_torch.eval.fold_parallel import train_folds_parallel

        arrays, groups = [], {}
        for k, (train_idx, val_idx) in enumerate(folds):
            tr_i, tr_m, va_i, va_m = self._fold_data(
                np.asarray(train_idx), np.asarray(val_idx), selected_augs,
                verbose=False)
            a = (*_materialize(tr_i, tr_m, device=self.device),
                 *_materialize(va_i, va_m, device=self.device))
            arrays.append(a)
            groups.setdefault((a[0].shape[0], a[2].shape[0]), []).append(k)
        if self.base_config.get("fold_parallel_strategy",
                                "stream") == "stream":
            groups = {None: list(range(len(folds)))}  # no size constraint

        seed = self.base_config.get("seed", 42)
        cfg = dict(self.base_config)
        cfg.update(
            num_epochs=(15 if self.quick_evaluation
                        else self.base_config["num_epochs"]),
            scheduler_threshold=0.01,
            early_stopping_patience=3 if self.quick_evaluation else 10,
            early_stopping_min_delta=0.01)

        scores: List[float] = [0.0] * len(folds)
        for ks in groups.values():
            out = train_folds_parallel(
                [arrays[k] for k in ks], cfg, seeds=[seed] * len(ks),
                auto_bias=False, device=self.device)
            for k, res in zip(ks, out):
                scores[k] = float(res["best_iou"])
        return scores

    def _evaluate_augmentation_set(self, selected_augs: List[str]) -> float:
        """Group-aware CV score for an augmentation set
        (forward_selection_integration.py:413-462)."""
        if selected_augs:
            print(f"\n  Testing: {' + '.join(selected_augs)}")
        else:
            print("\n  Testing: Baseline (no augmentation)")

        folds = group_kfold_split(self.base_names, self.cv_folds)
        for train_idx, val_idx in folds:
            train_bases = {self.base_names[i] for i in train_idx}
            val_bases = {self.base_names[i] for i in val_idx}
            assert not train_bases & val_bases, "Data leakage detected!"
        if self.base_config.get("fold_parallel"):
            scores = self._evaluate_folds_parallel(folds, selected_augs)
        else:
            scores = []
            for fold, (train_idx, val_idx) in enumerate(folds):
                print(f"    Fold {fold + 1}/{self.cv_folds}:")
                scores.append(self._train_and_evaluate_fold(
                    np.asarray(train_idx), np.asarray(val_idx),
                    selected_augs))
        mean, std = float(np.mean(scores)), float(np.std(scores))
        print(f"  Result: {mean:.4f} ± {std:.4f}")
        return mean

    # ------------------------------------------------------------ search

    def run_forward_selection(self, verbose: bool = True) -> Dict:
        """Greedy search — same algorithm as the reference's selector
        (forward_selection_integration.py:465-592): score the empty set,
        then per round score every remaining candidate added to the current
        set and keep the best one if it clears ``improvement_threshold``.
        The JSON result schema is the reference's; the console output is
        the JAX package's compact log format."""
        selected: List[str] = []
        remaining = list(self.augmentation_candidates)

        if verbose:
            print(f"forward-selection | {len(self.image_paths)} images "
                  f"(type {self.base_config['image_type']}), "
                  f"{self.base_config['backbone']}, "
                  f"{self.cv_folds}-fold grouped CV, "
                  f"{len(remaining)} candidates, "
                  f"threshold {self.improvement_threshold}")

        if verbose:
            print("forward-selection | scoring empty set (baseline)")
        baseline_score = self._evaluate_augmentation_set([])
        current_best = baseline_score
        if verbose:
            print(f"forward-selection | baseline IoU {baseline_score:.4f}")

        for iteration in range(self.max_augmentations):
            if verbose:
                sel = " + ".join(selected) if selected else "<empty>"
                print(f"forward-selection | round "
                      f"{iteration + 1}/{self.max_augmentations}: "
                      f"set={sel} (IoU {current_best:.4f}), trying "
                      f"{len(remaining)} candidates")

            best_candidate = None
            best_score = current_best
            candidate_scores = {}
            for i, candidate in enumerate(remaining):
                if verbose:
                    print(f"  candidate {i + 1}/{len(remaining)} "
                          f"{candidate}:", end="", flush=True)
                score = self._evaluate_augmentation_set(selected + [candidate])
                candidate_scores[candidate] = score
                if score > best_score:
                    best_score = score
                    best_candidate = candidate
                if verbose:
                    mark = " <- round leader" if candidate == best_candidate \
                        else ""
                    print(f"    delta {score - current_best:+.4f}{mark}")

            improvement = best_score - current_best
            if verbose and candidate_scores:
                ranked = sorted(candidate_scores.items(), key=lambda x: x[1],
                                reverse=True)[:3]
                summary = ", ".join(f"{n}={s:.4f}" for n, s in ranked)
                print(f"forward-selection | round {iteration + 1} "
                      f"leaders: {summary}")

            if best_candidate is None or \
                    improvement < self.improvement_threshold:
                if verbose:
                    print(f"forward-selection | converged: best gain "
                          f"{improvement:+.4f} < threshold "
                          f"{self.improvement_threshold} — search ends")
                break

            selected.append(best_candidate)
            remaining.remove(best_candidate)
            current_best = best_score
            self.selection_history.append({
                "iteration": iteration + 1,
                "selected": best_candidate,
                "current_set": list(selected),
                "score": best_score,
                "improvement": improvement,
                "candidate_scores": dict(candidate_scores),
            })
            if verbose:
                print(f"forward-selection | accepted {best_candidate} "
                      f"({improvement:+.4f}) -> IoU {current_best:.4f}")

        results = {
            "selected_augmentations": selected,
            "final_score": current_best,
            "baseline_score": baseline_score,
            "total_improvement": current_best - baseline_score,
            "selection_history": self.selection_history,
            "config": self.base_config,
        }
        if verbose:
            pct = ((current_best - baseline_score) / baseline_score * 100) \
                if baseline_score else 0.0
            final_set = " + ".join(selected) if selected else "none"
            print(f"forward-selection | done: selected [{final_set}], "
                  f"IoU {baseline_score:.4f} -> {current_best:.4f} "
                  f"({pct:+.1f}%)")
        return results

    def create_optimal_pipeline(self, selected_augs: List[str]):
        """Production pipeline with realistic probabilities
        (forward_selection_integration.py:594-599)."""
        return build_pipeline(selected_augs, for_selection=False)


def run_augmentation_selection_experiment(
        data_dir: str = "manual_labels", config_overrides: Dict = None,
        improvement_threshold: float = 0.005, max_augmentations: int = 10,
        cv_folds: int = 5, quick_evaluation: bool = False,
        save_root: str = "experiments", *, device="cuda"):
    """Experiment entry point
    (forward_selection_integration.py:602-662)."""
    config = {
        "name": "augmentation_selection",
        "model_type": "unet",
        "image_type": "W",
        "backbone": "resnet34",
        "use_attention": False,
        "batch_size": 2,
        "img_size": (128, 128),
        "num_epochs": 25,
        "learning_rate": 1e-3,
        "weight_decay": 1e-5,
        "pretrained": True,
        "seed": 42,
        "loss_fn": "focal",
        "focal_alpha": 0.25,
        "focal_gamma": 2.0,
    }
    config.update(config_overrides or {})

    print("Starting augmentation selection experiment")
    print(f"Image type: {config['image_type']}")
    print(f"Model: {config['backbone']} with attention: "
          f"{config['use_attention']}")

    selector = AugmentationSelector(
        base_config=config, data_dir=data_dir,
        improvement_threshold=improvement_threshold,
        max_augmentations=max_augmentations, cv_folds=cv_folds,
        quick_evaluation=quick_evaluation, device=device)

    results = selector.run_forward_selection(verbose=True)

    out_dir = os.path.join(save_root, "augmentation_selection_results")
    save_results(out_dir, "results.json", results)

    optimal_pipeline = selector.create_optimal_pipeline(
        results["selected_augmentations"])
    print("\nOptimal augmentation pipeline created!")
    print(f"selected_augs = {results['selected_augmentations']}")
    return results, optimal_pipeline


if __name__ == "__main__":
    # `python -m segtpu_torch.experiments.forward_selection` — the analog
    # of the reference's `python forward_selection_integration.py`
    import sys
    if len(sys.argv) > 1:
        sys.exit("this entry runs the reference defaults and takes no "
                 "flags; use `python -m segtpu_torch.cli --experiment "
                 "augmentation_selection ...` instead")
    run_augmentation_selection_experiment()
