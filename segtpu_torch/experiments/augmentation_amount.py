"""Augmentation-amount sweep (port of
``segtpu/experiments/augmentation_amount.py``; every model trains on
``device``, default ``cuda``).

Reference parity: augmentation_amount_experiment.py — sweeps
``augmentations_per_image``, CV per amount on identical protocol, the
``IoU/(1+amount)`` efficiency metric (:87), diminishing-returns/ROI
analysis (:167-182), the 6-panel plot (:184-305) and JSON summary."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from segtpu_torch.core.config import set_seed
from segtpu_torch.eval.cross_validation import CrossValidator
from segtpu_torch.experiments.common import (draw_figure, save_results,
                                             timestamp)
from segtpu_torch.models import UNetWithBackbone


class AugmentationAmountExperiment:
    """Sweep augmentation amounts with the shared CV harness
    (augmentation_amount_experiment.py:18-349).

    The reference sweeps ``range(1, 51)`` (augmentation_amount_experiment
    .py:389); the default here is a subsampled grid that brackets the
    reference's measured knee (≈9 aug/img, BASELINE.md) at a fraction of
    the compute — pass ``augmentation_amounts=range(1, 51)`` for the
    reference's full grid (see REFERENCE_GRID)."""

    #: the reference's own sweep (augmentation_amount_experiment.py:389)
    REFERENCE_GRID = tuple(range(1, 51))

    def __init__(self, base_config: Dict,
                 augmentation_amounts: List[int] = (0, 1, 2, 3, 5, 10), *,
                 device="cuda"):
        self.device = device
        self.base_config = base_config
        self.augmentation_amounts = list(augmentation_amounts)
        self.results: Dict = {}

    def run_augmentation_comparison(self) -> Dict:
        print("=" * 60)
        print("AUGMENTATION AMOUNT EXPERIMENT")
        print("=" * 60)
        print(f"Model: {self.base_config['backbone']} UNet")
        print(f"Testing augmentation amounts: {self.augmentation_amounts}")

        aug_results = {}
        detailed_results = {}
        for aug_amount in self.augmentation_amounts:
            print(f"\n{'='*40}\nTESTING {aug_amount} AUGMENTATIONS PER IMAGE"
                  f"\n{'='*40}")
            current_config = dict(self.base_config)
            current_config["name"] = f"{aug_amount} Augmentations"

            cv = CrossValidator(
                data_dir=self.base_config["data_dir"],
                image_type=self.base_config["image_type"],
                n_splits=self.base_config.get("n_splits", 5),
                random_state=self.base_config["random_state"],
                augmentations_per_image=aug_amount,
                verbose=True,
                fold_parallel=self.base_config.get("fold_parallel", False),
                device=self.device)

            cv_results = cv.cross_validate_single_model(
                model_class=UNetWithBackbone, config=current_config)

            s = cv_results["cv_summary"]
            efficiency_iou = s["iou_mean"] / (1 + aug_amount)
            aug_results[aug_amount] = {
                "mean_iou": s["iou_mean"], "std_iou": s["iou_std"],
                "mean_f1": s["f1_mean"], "std_f1": s["f1_std"],
                "fold_scores": [f["iou"] for f in cv_results["fold_results"]],
                "data_multiplier": 1 + aug_amount,
                "efficiency_iou": efficiency_iou,
                "cv_summary": s,
            }
            detailed_results[aug_amount] = cv_results
            print(f"\n{aug_amount} augmentations: IoU "
                  f"{s['iou_mean']:.4f} ± {s['iou_std']:.4f}, "
                  f"efficiency {efficiency_iou:.4f}")

        self.results = {
            "augmentation_results": aug_results,
            "detailed_results": detailed_results,
            "config": self.base_config,
            "augmentation_amounts_tested": list(aug_results.keys()),
        }
        self._print_summary()
        return self.results

    def _print_summary(self):
        """Ranked summary + ROI analysis
        (augmentation_amount_experiment.py:122-182)."""
        res = self.results["augmentation_results"]
        if not res:
            print("No results to summarize!")
            return
        ranked = sorted(res.items(), key=lambda x: x[1]["mean_iou"],
                        reverse=True)
        print(f"\n{'='*60}\nAUGMENTATION AMOUNT SUMMARY\n{'='*60}")
        print("Rank | Aug/Img | IoU ± Std       | Data Mult | Efficiency")
        for i, (amount, r) in enumerate(ranked):
            print(f"{i+1:4d} | {amount:7d} | {r['mean_iou']:.4f} ± "
                  f"{r['std_iou']:.4f} | {r['data_multiplier']:8d}x | "
                  f"{r['efficiency_iou']:.4f}")

        best_amount, best = ranked[0]
        print(f"\nBEST PERFORMANCE: {best_amount} aug/img "
              f"(IoU {best['mean_iou']:.4f})")
        best_eff = max(res.items(), key=lambda x: x[1]["efficiency_iou"])
        if best_eff[0] != best_amount:
            print(f"BEST EFFICIENCY: {best_eff[0]} aug/img "
                  f"({best_eff[1]['efficiency_iou']:.4f})")

        baseline_amount = min(res.keys())
        baseline_iou = res[baseline_amount]["mean_iou"]
        print("\nROI vs baseline:")
        for amount, r in sorted(res.items()):
            if amount == baseline_amount:
                continue
            improvement = r["mean_iou"] - baseline_iou
            roi = improvement / amount if amount > 0 else 0.0
            print(f"  - {amount} aug: +{improvement:.4f} IoU "
                  f"(ROI: {roi:.4f})")

    def plot_results(self, save_dir: str = None):
        """6-panel figure (augmentation_amount_experiment.py:184-305)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        res = self.results.get("augmentation_results", {})
        if not res:
            print("No results to plot!")
            return
        amounts = sorted(res.keys())
        means = [res[a]["mean_iou"] for a in amounts]
        stds = [res[a]["std_iou"] for a in amounts]
        mults = [res[a]["data_multiplier"] for a in amounts]
        effs = [res[a]["efficiency_iou"] for a in amounts]

        plt.figure(figsize=(15, 10))

        plt.subplot(2, 3, 1)
        plt.errorbar(amounts, means, yerr=stds, marker="o", linewidth=2,
                     markersize=8, capsize=5, capthick=2, color="blue")
        best_idx = int(np.argmax(means))
        plt.scatter(amounts[best_idx], means[best_idx], color="red", s=150,
                    zorder=5, marker="*", label="Best Performance")
        plt.xlabel("Augmentations per Image")
        plt.ylabel("IoU Score")
        plt.title("Performance vs Augmentation Amount")
        plt.grid(True, alpha=0.3)
        plt.legend()

        plt.subplot(2, 3, 2)
        plt.plot(amounts, effs, marker="s", linewidth=2, markersize=8,
                 color="green")
        be = int(np.argmax(effs))
        plt.scatter(amounts[be], effs[be], color="red", s=150, zorder=5,
                    marker="*", label="Best Efficiency")
        plt.xlabel("Augmentations per Image")
        plt.ylabel("IoU per Data Multiplier")
        plt.title("Training Efficiency")
        plt.grid(True, alpha=0.3)
        plt.legend()

        plt.subplot(2, 3, 3)
        plt.scatter(mults, means, s=100, alpha=0.7, color="purple")
        plt.xlabel("Data Multiplier")
        plt.ylabel("IoU Score")
        plt.title("Performance vs Dataset Size")
        plt.grid(True, alpha=0.3)

        plt.subplot(2, 3, 4)
        data = [res[a]["fold_scores"] for a in amounts]
        bp = plt.boxplot(data, tick_labels=[str(a) for a in amounts],
                         patch_artist=True)
        bp["boxes"][best_idx].set_facecolor("lightcoral")
        plt.xlabel("Augmentations per Image")
        plt.ylabel("IoU Score")
        plt.title("Distribution of Fold Scores")
        plt.grid(axis="y", alpha=0.3)

        plt.subplot(2, 3, 5)
        baseline_iou = means[0]
        improvements = [m - baseline_iou for m in means]
        plt.bar(amounts, improvements, alpha=0.7, color="orange")
        plt.axhline(y=0, color="red", linestyle="--", alpha=0.5)
        plt.xlabel("Augmentations per Image")
        plt.ylabel("IoU Improvement over Baseline")
        plt.title("Augmentation Benefit")
        plt.grid(axis="y", alpha=0.3)

        plt.subplot(2, 3, 6)
        costs = [a + 1 for a in amounts]
        plt.scatter(costs, means, s=100, alpha=0.7, color="brown")
        plt.xlabel("Relative Training Cost")
        plt.ylabel("IoU Score")
        plt.title("Performance vs Training Cost")
        plt.grid(True, alpha=0.3)

        plt.tight_layout()
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            plt.savefig(f"{save_dir}/augmentation_amount_results.png",
                        dpi=200, bbox_inches="tight")
            print(f"Plot saved to {save_dir}/augmentation_amount_results.png")
        plt.close()

    def save_results(self, save_dir: str):
        """JSON results + summary
        (augmentation_amount_experiment.py:307-349)."""
        os.makedirs(save_dir, exist_ok=True)
        save_results(save_dir, "augmentation_amount_results.json",
                     self.results)
        res = self.results.get("augmentation_results", {})
        summary = {
            "experiment_type": "augmentation_amount",
            "timestamp": timestamp(),
            "config": self.base_config,
            "augmentation_amounts_tested":
                self.results.get("augmentation_amounts_tested", []),
            "best_performance": None,
            "best_efficiency": None,
        }
        if res:
            bp = max(res.items(), key=lambda x: x[1]["mean_iou"])
            summary["best_performance"] = {
                "augmentations_per_image": bp[0],
                "mean_iou": bp[1]["mean_iou"], "std_iou": bp[1]["std_iou"],
                "data_multiplier": bp[1]["data_multiplier"]}
            be = max(res.items(), key=lambda x: x[1]["efficiency_iou"])
            summary["best_efficiency"] = {
                "augmentations_per_image": be[0],
                "efficiency_score": be[1]["efficiency_iou"],
                "mean_iou": be[1]["mean_iou"],
                "data_multiplier": be[1]["data_multiplier"]}
        save_results(save_dir, "augmentation_amount_summary.json", summary)


def main(data_dir: str = "data/manual_labels", image_type: str = "W",
         augmentation_amounts: List[int] = None, base_overrides: Dict = None,
         save_root: str = "experiments", *, device="cuda") -> Dict:
    """Driver (augmentation_amount_experiment.py:352-416, seed 42)."""
    set_seed(42)
    base_config = {
        "name": "Augmentation Amount Test",
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
        "verbose": False,
        "save_plots": False,
        "data_dir": data_dir,
        "image_type": image_type,
        "random_state": 42,
        "n_splits": 5,
        "loss_fn": "bce",
    }
    base_config.update(base_overrides or {})
    if augmentation_amounts is None:
        augmentation_amounts = list(range(1, 51))

    save_dir = os.path.join(save_root, f"augmentation_amount_{timestamp()}")
    print("=" * 60)
    print("AUGMENTATION AMOUNT EXPERIMENT")
    print(f"Testing augmentation amounts: {augmentation_amounts}")
    print(f"Results will be saved to: {save_dir}")
    print("=" * 60)

    experiment = AugmentationAmountExperiment(base_config,
                                              augmentation_amounts,
                                              device=device)
    results = experiment.run_augmentation_comparison()
    experiment.save_results(save_dir)
    draw_figure(experiment.plot_results, save_dir)
    print(f"\n{'='*60}\nAUGMENTATION AMOUNT EXPERIMENT COMPLETE!\n{'='*60}")
    return results


if __name__ == "__main__":
    # `python -m segtpu_torch.experiments.augmentation_amount` — the
    # analog of the reference's `python augmentation_amount_experiment.py`.
    # The reference is internally inconsistent about the data dir (this
    # script's __main__ uses 'data/manual_labels',
    # augmentation_amount_experiment.py:379, the loss sweep uses
    # 'manual_labels'); fall back to the common location when the
    # outlier path is absent.
    import os
    import sys
    if len(sys.argv) > 1:
        sys.exit("this entry runs the reference defaults and takes no "
                 "flags; use `python -m segtpu_torch.cli --experiment "
                 "augmentation_amount ...` instead")
    dd = "data/manual_labels"
    if not os.path.isdir(dd) and os.path.isdir("manual_labels"):
        dd = "manual_labels"
    main(data_dir=dd)
