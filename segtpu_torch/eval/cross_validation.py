"""Cross-validation and model-comparison protocols (port of
``segtpu/eval/cross_validation.py``).

Reference parity: cross_validation.py —
- ``CrossValidator`` (:20-298): data loaded once, KFold(shuffle, seed) over
  indices, a *fresh* model per fold trained through ``train_model``,
  mean/std aggregation of every metric, multi-model comparison on
  **identical folds** for fairness;
- ``ModelComparator`` (:301-423): up-front train/test split; CV on the
  train split only; generalization = retrain on the full train split with
  the held-out test set as the validation set (including the reference's
  best-epoch-peeks-at-test caveat, :377-394, kept for protocol parity).

The dataset's canonical uint8 frames are decoded, and resized on
``device``, once per ``img_size`` and sliced per fold on the host. Every
fold trains on ``device`` (default ``cuda``; raises without CUDA unless
``device='cpu'``). ``fold_parallel=True`` (the JAX package's
``eval/fold_parallel.py``) is not ported yet (ROADMAP A17).
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from segtpu_torch import resolve_device
from segtpu_torch.data.discovery import load_original_data
from segtpu_torch.data.preprocess import load_canonical
from segtpu_torch.eval.folds import kfold_split, train_test_split_indices
from segtpu_torch.train.loop import train_model
from segtpu_torch.train.optim import ReduceLROnPlateau


def _plateau(config: Dict) -> ReduceLROnPlateau:
    """The harness's scheduler (cross_validation.py:96-98)."""
    return ReduceLROnPlateau(
        initial_lr=config.get("learning_rate", 1e-3), mode="max",
        factor=0.5, patience=3, min_lr=1e-6)


def _summary(all_metrics: Dict[str, List[float]]) -> Dict[str, float]:
    out = {}
    for metric, values in all_metrics.items():
        out[f"{metric}_mean"] = float(np.mean(values))
        out[f"{metric}_std"] = float(np.std(values))
    return out


class CrossValidator:
    """K-fold cross-validation over the cell dataset
    (reference: cross_validation.py:20-298)."""

    def __init__(self, data_dir: str = "manual_labels", image_type: str = "W",
                 n_splits: int = 5, random_state: int = 42,
                 augmentations_per_image: int = 3, verbose: bool = True,
                 resume_dir: Optional[str] = None,
                 fold_parallel: bool = False, *, device="cuda"):
        if fold_parallel:
            raise NotImplementedError("fold_parallel=True needs the port of "
                                      "segtpu/eval/fold_parallel.py "
                                      "(ROADMAP A17)")
        self.device = resolve_device(device)
        self.n_splits = n_splits
        self.random_state = random_state
        self.augmentations_per_image = augmentations_per_image
        self.verbose = verbose
        # failure recovery: every completed fold's metrics persist as JSON
        # and a restarted run skips past them (the folds are deterministic
        # given the seed)
        self.resume_dir = resume_dir

        self.data = load_original_data(data_dir, image_type)
        self.image_paths = self.data["image_paths"]
        self.mask_paths = self.data["mask_paths"]
        self._canonical_cache: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

        if verbose:
            print(f"Loaded {len(self.image_paths)} {image_type} images for CV")

    # ------------------------------------------------------------ data

    def _canonical(self, img_size) -> Tuple[np.ndarray, np.ndarray]:
        key = tuple(img_size)
        if key not in self._canonical_cache:
            self._canonical_cache[key] = load_canonical(
                self.image_paths, self.mask_paths, key, device=self.device)
        return self._canonical_cache[key]

    # ------------------------------------------------------------ folds

    def create_cv_folds(self, indices: Optional[List[int]] = None
                        ) -> List[Tuple[List[int], List[int]]]:
        """KFold over ``indices`` (all data if None)
        (cross_validation.py:50-75)."""
        if indices is None:
            indices = list(range(len(self.image_paths)))
        folds = []
        for tr, va in kfold_split(len(indices), self.n_splits, shuffle=True,
                                  random_state=self.random_state):
            folds.append(([indices[i] for i in tr], [indices[i] for i in va]))
        if self.verbose:
            print(f"Created {self.n_splits} CV folds from {len(indices)} "
                  f"samples")
        return folds

    # ------------------------------------------------------------ training

    def train_single_model(self, model_class, config: Dict,
                           train_idx: Sequence[int], val_idx: Sequence[int],
                           fold_idx: int = 0) -> Dict:
        """Train a fresh model on one fold; returns its final validation
        metrics (cross_validation.py:77-124). ``model_class`` is accepted
        for API parity; the model is built from config (backbone,
        use_attention).

        ``fold_idx`` varies the init seed per fold (seed + 1000·fold): the
        reference draws a fresh random init each fold, so the fold std
        includes the init's variance."""
        img_size = tuple(config.get("img_size", (128, 128)))
        ci, cm = self._canonical(img_size)
        cv_config = dict(config)
        cv_config["verbose"] = False
        cv_config["save_plots"] = False
        cv_config["seed"] = int(config.get("seed", 0)) + 1000 * fold_idx
        results = train_model(
            model=None,
            train_images=ci[list(train_idx)], train_masks=cm[list(train_idx)],
            val_images=ci[list(val_idx)], val_masks=cm[list(val_idx)],
            criterion=None,
            optimizer={"learning_rate": config.get("learning_rate", 1e-3),
                       "weight_decay": config.get("weight_decay", 1e-5)},
            scheduler=_plateau(config),
            num_epochs=config.get("num_epochs", 50),
            device=self.device, config=cv_config,
            augmentations_per_image=self.augmentations_per_image,
            save_plots=False)
        return results["final_val_metrics"]

    def _fold_ckpt_path(self, config: Dict, fold_idx: int) -> Optional[str]:
        if not self.resume_dir:
            return None
        name = re.sub(r"[^A-Za-z0-9_.-]", "_",
                      str(config.get("name", "model")))
        os.makedirs(self.resume_dir, exist_ok=True)
        return os.path.join(self.resume_dir, f"{name}_fold{fold_idx}.json")

    def _run_folds(self, model_class, config: Dict, cv_folds
                   ) -> Tuple[List, Dict]:
        fold_results = []
        all_metrics = defaultdict(list)
        for fold_idx, (tr, va) in enumerate(cv_folds):
            ckpt = self._fold_ckpt_path(config, fold_idx)
            if ckpt and os.path.exists(ckpt):
                with open(ckpt) as f:
                    val_metrics = json.load(f)
                if self.verbose:
                    print(f"  Fold {fold_idx + 1}/{self.n_splits}: resumed "
                          f"(IoU: {val_metrics['iou']:.4f})")
            else:
                if self.verbose:
                    print(f"  Fold {fold_idx + 1}/{self.n_splits}:", end=" ")
                t0 = time.time()
                val_metrics = dict(self.train_single_model(
                    model_class, config, tr, va, fold_idx=fold_idx))
                elapsed = time.time() - t0
                val_metrics["training_time"] = elapsed
                if ckpt:
                    with open(ckpt, "w") as f:
                        json.dump({k: float(v)
                                   for k, v in val_metrics.items()}, f)
                if self.verbose:
                    print(f"IoU: {val_metrics['iou']:.4f} ({elapsed:.1f}s)")
            fold_results.append(val_metrics)
            for metric, value in val_metrics.items():
                if metric != "training_time":
                    all_metrics[metric].append(value)
        return fold_results, _summary(all_metrics)

    def cross_validate_single_model(self, model_class=None,
                                    config: Dict = None,
                                    indices: Optional[List[int]] = None
                                    ) -> Dict:
        """CV one model (cross_validation.py:126-194)."""
        config = dict(config or {})
        if self.verbose:
            print(f"\nCross-validating {config.get('name', 'Model')}...")
        cv_folds = self.create_cv_folds(indices)
        fold_results, cv_summary = self._run_folds(model_class, config,
                                                   cv_folds)
        if self.verbose:
            print(f"  Overall: {cv_summary['iou_mean']:.4f} ± "
                  f"{cv_summary['iou_std']:.4f}")
        return {"config": config, "fold_results": fold_results,
                "cv_summary": cv_summary}

    def compare_multiple_models(self, model_configs: List[Tuple],
                                indices: Optional[List[int]] = None) -> Dict:
        """Compare models on IDENTICAL folds (cross_validation.py:196-298)."""
        if self.verbose:
            print(f"\nComparing {len(model_configs)} models with "
                  f"{self.n_splits}-fold CV...")
        cv_folds = self.create_cv_folds(indices)

        all_results = {}
        comparison_summary = {}
        for model_class, config in model_configs:
            model_name = config.get("name", "Unknown")
            if self.verbose:
                print(f"\nTesting {model_name}...")
            fold_results, cv_summary = self._run_folds(model_class, config,
                                                       cv_folds)
            all_results[model_name] = {"config": config,
                                       "fold_results": fold_results,
                                       "cv_summary": cv_summary}
            comparison_summary[model_name] = cv_summary
            if self.verbose:
                print(f"  {model_name}: {cv_summary['iou_mean']:.4f} ± "
                      f"{cv_summary['iou_std']:.4f}")

        if self.verbose:
            print(f"\n{'=' * 60}\nMODEL COMPARISON SUMMARY\n{'=' * 60}")
            ranked = sorted(comparison_summary.items(),
                            key=lambda x: x[1]["iou_mean"], reverse=True)
            for i, (name, summary) in enumerate(ranked):
                print(f"{i + 1:2d}. {name:25}: {summary['iou_mean']:.4f} ± "
                      f"{summary['iou_std']:.4f}")

        return {"individual_results": all_results,
                "comparison_summary": comparison_summary,
                "cv_folds_used": len(cv_folds)}


class ModelComparator:
    """CV on a train split + held-out generalization testing
    (reference: cross_validation.py:301-423)."""

    def __init__(self, data_dir: str = "manual_labels", image_type: str = "W",
                 test_size: float = 0.2, n_splits: int = 5,
                 random_state: int = 42, augmentations_per_image: int = 3,
                 verbose: bool = True, fold_parallel: bool = False, *,
                 device="cuda"):
        self.cv = CrossValidator(data_dir, image_type, n_splits, random_state,
                                 augmentations_per_image, verbose,
                                 fold_parallel=fold_parallel, device=device)
        self.test_size = test_size
        self.random_state = random_state
        self.verbose = verbose

        self.train_indices, self.test_indices = train_test_split_indices(
            len(self.cv.image_paths), test_size=test_size,
            random_state=random_state)
        if verbose:
            print(f"Created train/test split: {len(self.train_indices)}"
                  f"/{len(self.test_indices)}")

    def run_cv_comparison(self, model_configs: List[Tuple]) -> Dict:
        """CV comparison on the training split only
        (cross_validation.py:326-328)."""
        return self.cv.compare_multiple_models(model_configs,
                                               self.train_indices)

    def evaluate_generalization(self, model_configs: List[Tuple]) -> Dict:
        """Retrain on the full train split; report metrics on the held-out
        test set (cross_validation.py:330-423)."""
        if self.verbose:
            print(f"\n{'=' * 60}\nGENERALIZATION EVALUATION\n{'=' * 60}")

        generalization_results = {}
        for model_class, config in model_configs:
            model_name = config.get("name", "Unknown")
            if self.verbose:
                print(f"\nTraining {model_name} on full training set...")
            img_size = tuple(config.get("img_size", (128, 128)))
            ci, cm = self.cv._canonical(img_size)

            gen_config = dict(config)
            gen_config["verbose"] = False
            gen_config["save_plots"] = False

            t0 = time.time()
            results = train_model(
                model=None,
                train_images=ci[self.train_indices],
                train_masks=cm[self.train_indices],
                val_images=ci[self.test_indices],
                val_masks=cm[self.test_indices],
                optimizer={"learning_rate": config.get("learning_rate", 1e-3),
                           "weight_decay": config.get("weight_decay", 1e-5)},
                scheduler=_plateau(config),
                num_epochs=gen_config.get("num_epochs", 50),
                device=self.cv.device, config=gen_config,
                augmentations_per_image=self.cv.augmentations_per_image,
                save_plots=False)
            training_time = time.time() - t0

            test_metrics = results["final_val_metrics"]
            generalization_results[model_name] = {
                "final_train_iou": results["best_iou"],
                "test_metrics": dict(test_metrics),
                "training_time": training_time,
            }
            if self.verbose:
                print(f"  Test IoU: {test_metrics['iou']:.4f}")

        if self.verbose:
            print(f"\n{'=' * 60}\nGENERALIZATION SUMMARY\n{'=' * 60}")
            ranked = sorted(generalization_results.items(),
                            key=lambda x: x[1]["test_metrics"]["iou"],
                            reverse=True)
            for i, (name, res) in enumerate(ranked):
                gap = res["final_train_iou"] - res["test_metrics"]["iou"]
                print(f"{i + 1:2d}. {name:25}: Test IoU = "
                      f"{res['test_metrics']['iou']:.4f}, "
                      f"Overfitting = {gap:.4f}")
        return generalization_results


def quick_cv(model_class=None, config: Dict = None,
             data_dir: str = "manual_labels", image_type: str = "W",
             n_splits: int = 5, augmentations_per_image: int = 3, *,
             device="cuda") -> Dict:
    """Convenience single-model CV (cross_validation.py:427-432)."""
    cv = CrossValidator(data_dir=data_dir, image_type=image_type,
                        n_splits=n_splits,
                        augmentations_per_image=augmentations_per_image,
                        device=device)
    return cv.cross_validate_single_model(model_class, config)


def quick_model_comparison(model_configs: List[Tuple],
                           data_dir: str = "manual_labels",
                           image_type: str = "W", n_splits: int = 5,
                           augmentations_per_image: int = 3,
                           include_generalization: bool = False, *,
                           device="cuda") -> Dict:
    """Convenience multi-model comparison (cross_validation.py:435-448)."""
    if include_generalization:
        comparator = ModelComparator(
            data_dir=data_dir, image_type=image_type, n_splits=n_splits,
            augmentations_per_image=augmentations_per_image, device=device)
        cv_results = comparator.run_cv_comparison(model_configs)
        gen_results = comparator.evaluate_generalization(model_configs)
        return {"cv_results": cv_results,
                "generalization_results": gen_results}
    cv = CrossValidator(data_dir=data_dir, image_type=image_type,
                        n_splits=n_splits,
                        augmentations_per_image=augmentations_per_image,
                        device=device)
    return cv.compare_multiple_models(model_configs)
