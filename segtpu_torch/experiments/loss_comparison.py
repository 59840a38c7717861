"""Loss-function comparison experiment (port of
``segtpu/experiments/loss_comparison.py``).

Reference parity: loss_function_cross_validation.py — the same 10 loss
configurations over a fixed base config (:18-59), Phase 1 CV on the train
split, Phase 2 generalization on the held-out test set, CV↔test correlation
and ranking-stability analysis, and the 3-/6-panel comparison plots.
Results persist as JSON (not pickles). Every model trains on ``device``
(default ``cuda``)."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from segtpu_torch.eval.cross_validation import ModelComparator
from segtpu_torch.experiments.common import (draw_figure, save_results,
                                             timestamp)
from segtpu_torch.models import UNetWithBackbone


def get_loss_configurations(base_overrides: Dict = None) -> List[Dict]:
    """The 10 loss configs of loss_function_cross_validation.py:18-59."""
    base_config = {
        "backbone": "resnet34",
        "use_attention": False,
        "batch_size": 4,
        "num_epochs": 50,
        "img_size": (128, 128),
        "learning_rate": 1e-3,
        "weight_decay": 1e-5,
        "pretrained": True,
        "early_stopping_patience": 5,
        "early_stopping_min_delta": 0.001,
        "verbose": True,
        "save_plots": False,
    }
    base_config.update(base_overrides or {})

    return [
        # Distribution-based
        {**base_config, "name": "BCE Loss", "loss_fn": "bce"},
        {**base_config, "name": "Weighted BCE", "loss_fn": "weighted_bce",
         "beta": 2.0},
        {**base_config, "name": "Balanced BCE", "loss_fn": "balanced_bce"},
        {**base_config, "name": "Focal Loss", "loss_fn": "focal",
         "focal_alpha": 0.25, "focal_gamma": 2.0},
        # Region-based
        {**base_config, "name": "Dice Loss", "loss_fn": "dice", "smooth": 1.0},
        {**base_config, "name": "Tversky Loss", "loss_fn": "tversky",
         "tversky_alpha": 0.5, "tversky_beta": 0.5},
        {**base_config, "name": "Focal Tversky", "loss_fn": "focal_tversky",
         "tversky_alpha": 0.5, "tversky_beta": 0.5,
         "focal_tversky_gamma": 0.75},
        {**base_config, "name": "Sensitivity-Specificity",
         "loss_fn": "sensitivity_specificity", "sensitivity_weight": 0.5},
        {**base_config, "name": "Log-Cosh Dice", "loss_fn": "log_cosh_dice",
         "smooth": 1.0},
        # Compound
        {**base_config, "name": "Combo Loss", "loss_fn": "combo",
         "loss_alpha": 0.5},
    ]


def plot_cv_results(cv_results: Dict, save_dir: str) -> None:
    """CV comparison figure (loss_function_cross_validation.py:62-129)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cv_summary = cv_results["comparison_summary"]
    names = list(cv_summary.keys())
    ious = [cv_summary[n]["iou_mean"] for n in names]
    stds = [cv_summary[n]["iou_std"] for n in names]
    f1s = [cv_summary[n]["f1_mean"] for n in names]
    order = np.argsort(ious)[::-1]

    plt.figure(figsize=(15, 5))
    plt.subplot(1, 3, 1)
    bars = plt.bar(range(len(names)), [ious[i] for i in order],
                   yerr=[stds[i] for i in order], capsize=5, alpha=0.7)
    plt.xticks(range(len(names)), [names[i] for i in order], rotation=45,
               ha="right")
    plt.ylabel("IoU")
    plt.title("Cross-Validation IoU Performance")
    plt.grid(axis="y", alpha=0.3)
    # value labels above the error bars (loss_function_cross_validation
    # .py:91-93)
    for bar, i in zip(bars, order):
        plt.text(bar.get_x() + bar.get_width() / 2,
                 bar.get_height() + stds[i] + 0.01, f"{ious[i]:.3f}",
                 ha="center", va="bottom", fontsize=8)

    plt.subplot(1, 3, 2)
    plt.bar(range(len(names)), [f1s[i] for i in order], alpha=0.7,
            color="orange")
    plt.xticks(range(len(names)), [names[i] for i in order], rotation=45,
               ha="right")
    plt.ylabel("F1 Score")
    plt.title("Cross-Validation F1 Performance")
    plt.grid(axis="y", alpha=0.3)

    plt.subplot(1, 3, 3)
    plt.axis("off")
    table_data = [[names[i], f"{ious[i]:.4f} ± {stds[i]:.4f}",
                   f"{f1s[i]:.4f}"] for i in order]
    table = plt.table(cellText=table_data,
                      colLabels=["Loss Function", "CV IoU", "CV F1"],
                      cellLoc="center", loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(9)
    table.scale(1, 1.5)
    plt.title("Cross-Validation Summary\n(Ranked by IoU)", pad=20)

    plt.tight_layout()
    plt.savefig(f"{save_dir}/cv_loss_comparison.png", dpi=200,
                bbox_inches="tight")
    plt.close()


def plot_generalization_results(cv_results: Dict, gen_results: Dict,
                                save_dir: str) -> None:
    """CV-vs-test scatter/rank figure
    (loss_function_cross_validation.py:132-258)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cv_summary = cv_results["comparison_summary"]
    names = list(gen_results.keys())
    cv_ious = [cv_summary[n]["iou_mean"] for n in names]
    test_ious = [gen_results[n]["test_metrics"]["iou"] for n in names]
    train_ious = [gen_results[n]["final_train_iou"] for n in names]
    overfit = [a - b for a, b in zip(train_ious, test_ious)]
    colors = plt.cm.tab10(np.linspace(0, 1, len(names)))
    test_order = np.argsort(test_ious)[::-1]

    plt.figure(figsize=(16, 10))

    plt.subplot(2, 3, 1)
    plt.scatter(cv_ious, test_ious, c=colors, s=150, alpha=0.7,
                edgecolors="black")
    for i, n in enumerate(names):
        plt.annotate(n, (cv_ious[i], test_ious[i]), xytext=(5, 5),
                     textcoords="offset points", fontsize=8)
    if len(set(cv_ious)) > 1:
        z = np.polyfit(cv_ious, test_ious, 1)
        xs = np.linspace(min(cv_ious), max(cv_ious), 100)
        plt.plot(xs, np.poly1d(z)(xs), "r--", alpha=0.8)
    r = np.corrcoef(cv_ious, test_ious)[0, 1] if len(names) > 1 else 0.0
    plt.xlabel("CV Mean IoU")
    plt.ylabel("Test IoU")
    plt.title(f"CV vs Test Performance\n(r = {r:.3f})")
    plt.grid(True, alpha=0.3)

    plt.subplot(2, 3, 2)
    plt.bar(range(len(names)), [test_ious[i] for i in test_order],
            color=[colors[i] for i in test_order], alpha=0.7)
    plt.xticks(range(len(names)), [names[i] for i in test_order],
               rotation=45, ha="right")
    plt.ylabel("IoU")
    plt.title("Test Set Performance (Generalization)")
    plt.grid(axis="y", alpha=0.3)

    plt.subplot(2, 3, 3)
    plt.bar(range(len(names)), [overfit[i] for i in test_order],
            color=[colors[i] for i in test_order], alpha=0.7)
    plt.xticks(range(len(names)), [names[i] for i in test_order],
               rotation=45, ha="right")
    plt.ylabel("Train IoU - Test IoU")
    plt.title("Overfitting Analysis")
    plt.axhline(y=0, color="red", linestyle="--", alpha=0.5)
    plt.grid(axis="y", alpha=0.3)

    plt.subplot(2, 3, 4)
    cv_order = np.argsort(cv_ious)[::-1]
    cv_ranks = [list(cv_order).index(i) + 1 for i in range(len(names))]
    test_ranks = [list(test_order).index(i) + 1 for i in range(len(names))]
    for i, n in enumerate(names):
        plt.plot([1, 2], [cv_ranks[i], test_ranks[i]], "o-", color=colors[i],
                 alpha=0.7, linewidth=2, markersize=8)
    plt.xticks([1, 2], ["CV Rank", "Test Rank"])
    plt.ylabel("Rank (1 = best)")
    plt.title("Ranking Stability")
    plt.grid(True, alpha=0.3)
    plt.gca().invert_yaxis()

    plt.subplot(2, 3, 5)
    plt.axis("off")
    rows = []
    for i in test_order:
        delta = cv_ranks[i] - test_ranks[i]
        sym = "↑" if delta > 0 else ("↓" if delta < 0 else "=")
        rows.append([names[i], f"{cv_ious[i]:.4f}", f"{test_ious[i]:.4f}",
                     f"{overfit[i]:.4f}", f"{cv_ranks[i]} → {test_ranks[i]} {sym}"])
    table = plt.table(cellText=rows,
                      colLabels=["Loss Function", "CV IoU", "Test IoU",
                                 "Overfit", "Rank Change"],
                      cellLoc="center", loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(8)
    table.scale(1, 2)
    plt.title("Complete Performance Summary\n(Ranked by Test IoU)", pad=20)

    plt.tight_layout()
    plt.savefig(f"{save_dir}/generalization_loss_comparison.png", dpi=200,
                bbox_inches="tight")
    plt.close()


def main(data_dir: str = "manual_labels", image_type: str = "W",
         n_splits: int = 5, test_size: float = 0.2,
         augmentations_per_image: int = 3, random_state: int = 42,
         base_overrides: Dict = None, save_root: str = "experiments",
         loss_filter: List[str] = None, fold_parallel: bool = False, *,
         device="cuda") -> Dict:
    """Full two-phase loss comparison
    (loss_function_cross_validation.py:261-392). ``loss_filter``
    optionally restricts to a subset of loss names (smoke runs);
    ``fold_parallel`` is not ported yet (ROADMAP A17)."""
    ts = timestamp()
    save_dir = os.path.join(save_root, f"loss_comparison_{ts}")
    os.makedirs(save_dir, exist_ok=True)

    print("=" * 80)
    print("LOSS FUNCTION COMPARISON")
    print("=" * 80)
    loss_configs = get_loss_configurations(base_overrides)
    if loss_filter:
        loss_configs = [c for c in loss_configs if c["name"] in loss_filter
                        or c["loss_fn"] in loss_filter]
    print(f"Testing {len(loss_configs)} loss functions:")
    for config in loss_configs:
        print(f"  - {config['name']}")

    model_configs = [(UNetWithBackbone, config) for config in loss_configs]

    print(f"\n{'='*60}\nPHASE 1: CROSS-VALIDATION ON TRAINING SET\n{'='*60}")
    comparator = ModelComparator(
        data_dir=data_dir, image_type=image_type, test_size=test_size,
        n_splits=n_splits, random_state=random_state,
        augmentations_per_image=augmentations_per_image, verbose=True,
        fold_parallel=fold_parallel, device=device)

    cv_results = comparator.run_cv_comparison(model_configs)
    save_results(save_dir, "cv_results.json",
                 {"cv_results": cv_results, "configs": loss_configs,
                  "timestamp": ts})
    draw_figure(plot_cv_results, cv_results, save_dir)

    print(f"\n{'='*60}\nPHASE 2: GENERALIZATION EVALUATION ON TEST SET\n{'='*60}")
    gen_results = comparator.evaluate_generalization(model_configs)
    save_results(save_dir, "generalization_results.json",
                 {"generalization_results": gen_results,
                  "configs": loss_configs, "timestamp": ts})
    draw_figure(plot_generalization_results, cv_results, gen_results,
                save_dir)

    # Summary + correlation analysis (:343-392)
    cv_summary = cv_results["comparison_summary"]
    best_cv = max(cv_summary.items(), key=lambda x: x[1]["iou_mean"])
    best_test = max(gen_results.items(),
                    key=lambda x: x[1]["test_metrics"]["iou"])
    print(f"\nBest by Cross-Validation: {best_cv[0]}: "
          f"IoU = {best_cv[1]['iou_mean']:.4f} ± {best_cv[1]['iou_std']:.4f}")
    print(f"Best by Test Set: {best_test[0]}: "
          f"IoU = {best_test[1]['test_metrics']['iou']:.4f}")
    if best_cv[0] == best_test[0]:
        print(f"CONSISTENT WINNER: {best_cv[0]}")
    cv_ious = [cv_summary[n]["iou_mean"] for n in cv_summary]
    test_ious = [gen_results[n]["test_metrics"]["iou"] for n in cv_summary]
    correlation = float(np.corrcoef(cv_ious, test_ious)[0, 1]) \
        if len(cv_ious) > 1 else 0.0
    print(f"CV-Test Correlation: r = {correlation:.3f}")

    print(f"\nAll results saved to: {save_dir}")
    return {"cv_results": cv_results, "generalization_results": gen_results,
            "correlation": correlation, "save_dir": save_dir}


if __name__ == "__main__":
    # direct-run parity with the reference's standalone scripts
    # (README.md "or directly: python loss_function_cross_validation.py"):
    # `python -m segtpu_torch.experiments.loss_comparison` from the root
    # runs the experiment with the reference defaults. Flags belong to
    # the CLI launcher, not here.
    import sys
    if len(sys.argv) > 1:
        sys.exit("this entry runs the reference defaults and takes no "
                 "flags; use `python -m segtpu_torch.cli --experiment "
                 "loss_function ...` instead")
    main()
