"""Model-configuration grid search (port of
``segtpu/experiments/model_configuration.py``).

Reference parity: model_configuration_experiment.py — Cartesian grid over
{backbone, use_attention, batch_size} (:460-464), CV + generalization via
ModelComparator, per-factor marginal-effect analysis (:182-223), the
interaction heatmap (:334-368), seed 41 (:427-432). Every model trains on
``device`` (default ``cuda``)."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from segtpu_torch.core.config import expand_grid, set_seed
from segtpu_torch.eval.cross_validation import ModelComparator
from segtpu_torch.experiments.common import (draw_figure, save_results,
                                             timestamp)
from segtpu_torch.models import UNetWithBackbone


class ModelConfigurationExperiment:
    """Grid search over model configurations
    (model_configuration_experiment.py:20-422)."""

    def __init__(self, base_config: Dict, configuration_options: Dict, *,
                 device="cuda"):
        self.device = device
        self.base_config = base_config
        self.configuration_options = configuration_options
        self.results: Dict = {}
        print("Generating model configuration combinations...")
        self.model_configs = expand_grid(base_config, configuration_options)
        print(f"Generated {len(self.model_configs)} model configurations:")
        for config in self.model_configs:
            print(f"  - {config['name']}")

    def run_model_comparison(self) -> Dict:
        print(f"{'='*60}\nMODEL CONFIGURATION EXPERIMENT\n{'='*60}")
        print(f"Testing {len(self.model_configs)} configurations")

        model_config_tuples = [(UNetWithBackbone, c) for c in self.model_configs]
        comparator = ModelComparator(
            data_dir=self.base_config["data_dir"],
            image_type=self.base_config["image_type"],
            test_size=self.base_config.get("test_size", 0.3),
            n_splits=self.base_config.get("n_splits", 5),
            random_state=self.base_config.get("random_state", 42),
            augmentations_per_image=self.base_config.get(
                "augmentations_per_image", 3),
            verbose=True,
            fold_parallel=self.base_config.get("fold_parallel", False),
            device=self.device)

        print(f"\n{'='*50}\nPHASE 1: CROSS-VALIDATION COMPARISON\n{'='*50}")
        cv_results = comparator.run_cv_comparison(model_config_tuples)
        print(f"\n{'='*50}\nPHASE 2: GENERALIZATION EVALUATION\n{'='*50}")
        gen_results = comparator.evaluate_generalization(model_config_tuples)

        self.results = {
            "cv_results": cv_results,
            "generalization_results": gen_results,
            "model_configs": self.model_configs,
            "configuration_options": self.configuration_options,
        }
        self._print_summary()
        return self.results

    def _print_summary(self):
        cv_summary = self.results["cv_results"]["comparison_summary"]
        gen_results = self.results["generalization_results"]
        if not cv_summary:
            print("No results to summarize!")
            return
        best_cv = max(cv_summary.items(), key=lambda x: x[1]["iou_mean"])
        best_test = max(gen_results.items(),
                        key=lambda x: x[1]["test_metrics"]["iou"])
        print(f"\n{'='*60}\nMODEL CONFIGURATION SUMMARY\n{'='*60}")
        print(f"BEST BY CV: {best_cv[0]} "
              f"({best_cv[1]['iou_mean']:.4f} ± {best_cv[1]['iou_std']:.4f})")
        print(f"BEST BY TEST: {best_test[0]} "
              f"({best_test[1]['test_metrics']['iou']:.4f})")
        if best_cv[0] == best_test[0]:
            print(f"CONSISTENT WINNER: {best_cv[0]}")
        cv_ious = [cv_summary[n]["iou_mean"] for n in cv_summary]
        test_ious = [gen_results[n]["test_metrics"]["iou"] for n in cv_summary]
        if len(cv_ious) > 1:
            r = float(np.corrcoef(cv_ious, test_ious)[0, 1])
            print(f"CV-TEST CORRELATION: r = {r:.3f}")
        self._analyze_configuration_effects()

    def _analyze_configuration_effects(self):
        """Per-factor marginal effects on test IoU
        (model_configuration_experiment.py:182-223)."""
        gen_results = self.results["generalization_results"]
        print(f"\n{'='*50}\nCOMPONENT ANALYSIS\n{'='*50}")
        self.component_effects = {}
        for option_name, values in self.configuration_options.items():
            effects = {}
            for value in values:
                ious = [gen_results[c["name"]]["test_metrics"]["iou"]
                        for c in self.model_configs
                        if c["config_params"][option_name] == value
                        and c["name"] in gen_results]
                if ious:
                    effects[value] = {"mean_iou": float(np.mean(ious)),
                                      "std_iou": float(np.std(ious)),
                                      "count": len(ious)}
            self.component_effects[option_name] = effects
            print(f"\n{option_name.upper()} EFFECTS:")
            for i, (value, stats) in enumerate(sorted(
                    effects.items(), key=lambda x: x[1]["mean_iou"],
                    reverse=True)):
                print(f"  {i+1}. {value}: {stats['mean_iou']:.4f} ± "
                      f"{stats['std_iou']:.4f} ({stats['count']} configs)")

    def plot_results(self, save_dir: str = None):
        """9-panel figure incl. factor effects + interaction heatmap
        (model_configuration_experiment.py:225-378)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if not self.results:
            print("No results to plot!")
            return
        cv_summary = self.results["cv_results"]["comparison_summary"]
        gen_results = self.results["generalization_results"]
        names = list(cv_summary.keys())
        cv_ious = [cv_summary[n]["iou_mean"] for n in names]
        cv_stds = [cv_summary[n]["iou_std"] for n in names]
        test_ious = [gen_results[n]["test_metrics"]["iou"] for n in names]

        plt.figure(figsize=(20, 16))

        plt.subplot(3, 3, 1)
        order = np.argsort(cv_ious)[::-1]
        plt.bar(range(len(names)), [cv_ious[i] for i in order],
                yerr=[cv_stds[i] for i in order], capsize=5, alpha=0.7)
        plt.xticks(range(len(names)),
                   [names[i].replace("_", "\n") for i in order],
                   rotation=45, ha="right", fontsize=8)
        plt.ylabel("IoU")
        plt.title("CV Performance (Ranked)", fontweight="bold")
        plt.grid(axis="y", alpha=0.3)

        plt.subplot(3, 3, 2)
        torder = np.argsort(test_ious)[::-1]
        plt.bar(range(len(names)), [test_ious[i] for i in torder],
                alpha=0.7, color="orange")
        plt.xticks(range(len(names)),
                   [names[i].replace("_", "\n") for i in torder],
                   rotation=45, ha="right", fontsize=8)
        plt.ylabel("IoU")
        plt.title("Test Performance (Ranked)", fontweight="bold")
        plt.grid(axis="y", alpha=0.3)

        plt.subplot(3, 3, 3)
        plt.scatter(cv_ious, test_ious, alpha=0.7, s=100)
        if len(set(cv_ious)) > 1:
            z = np.polyfit(cv_ious, test_ious, 1)
            xs = np.linspace(min(cv_ious), max(cv_ious), 100)
            plt.plot(xs, np.poly1d(z)(xs), "r--", alpha=0.8)
            r = np.corrcoef(cv_ious, test_ious)[0, 1]
            plt.title(f"CV vs Test Correlation\n(r = {r:.3f})",
                      fontweight="bold")
        plt.xlabel("CV IoU")
        plt.ylabel("Test IoU")
        plt.grid(True, alpha=0.3)

        plot_idx = 4
        for option_name in self.configuration_options:
            if plot_idx > 9:
                break
            plt.subplot(3, 3, plot_idx)
            labels, means, stds = [], [], []
            for value in self.configuration_options[option_name]:
                ious = [gen_results[c["name"]]["test_metrics"]["iou"]
                        for c in self.model_configs
                        if c["config_params"][option_name] == value
                        and c["name"] in gen_results]
                if ious:
                    labels.append(str(value))
                    means.append(np.mean(ious))
                    stds.append(np.std(ious))
            plt.bar(labels, means, yerr=stds, capsize=5, alpha=0.7)
            plt.ylabel("Test IoU")
            plt.title(f"Effect of {option_name.replace('_', ' ').title()}",
                      fontweight="bold")
            plt.grid(axis="y", alpha=0.3)
            plot_idx += 1

        main_factors = [f for f in ("backbone", "use_attention", "batch_size")
                        if f in self.configuration_options]
        if len(main_factors) >= 2 and plot_idx <= 9:
            plt.subplot(3, 3, plot_idx)
            f1, f2 = main_factors[:2]
            v1 = self.configuration_options[f1]
            v2 = self.configuration_options[f2]
            matrix = np.full((len(v1), len(v2)), np.nan)
            for i, a in enumerate(v1):
                for j, b in enumerate(v2):
                    ious = [gen_results[c["name"]]["test_metrics"]["iou"]
                            for c in self.model_configs
                            if c["config_params"][f1] == a
                            and c["config_params"][f2] == b
                            and c["name"] in gen_results]
                    if ious:
                        matrix[i, j] = np.mean(ious)
            try:
                import seaborn as sns
                sns.heatmap(matrix, xticklabels=[str(v) for v in v2],
                            yticklabels=[str(v) for v in v1], annot=True,
                            fmt=".3f", cmap="viridis")
            except ImportError:
                plt.imshow(matrix, cmap="viridis")
                plt.colorbar()
            plt.xlabel(f2.replace("_", " ").title())
            plt.ylabel(f1.replace("_", " ").title())
            plt.title(f"{f1} × {f2} Interaction", fontweight="bold")

        plt.tight_layout()
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            plt.savefig(f"{save_dir}/model_configuration_results.png",
                        dpi=200, bbox_inches="tight")
            print(f"Plot saved to {save_dir}/model_configuration_results.png")
        plt.close()

    def save_results(self, save_dir: str):
        """JSON results + summary
        (model_configuration_experiment.py:380-422)."""
        os.makedirs(save_dir, exist_ok=True)
        save_results(save_dir, "model_configuration_results.json", self.results)
        summary = {
            "experiment_type": "model_configuration",
            "timestamp": timestamp(),
            "base_config": self.base_config,
            "configuration_options": self.configuration_options,
            "total_configurations_tested": len(self.model_configs),
            "best_cv_config": None,
            "best_test_config": None,
        }
        if self.results:
            cv_summary = self.results["cv_results"]["comparison_summary"]
            gen_results = self.results["generalization_results"]
            if cv_summary:
                best_cv = max(cv_summary.items(),
                              key=lambda x: x[1]["iou_mean"])
                summary["best_cv_config"] = {
                    "name": best_cv[0], "mean_iou": best_cv[1]["iou_mean"],
                    "std_iou": best_cv[1]["iou_std"]}
            if gen_results:
                best_test = max(gen_results.items(),
                                key=lambda x: x[1]["test_metrics"]["iou"])
                summary["best_test_config"] = {
                    "name": best_test[0],
                    "test_iou": best_test[1]["test_metrics"]["iou"],
                    "test_f1": best_test[1]["test_metrics"]["f1"]}
        save_results(save_dir, "model_configuration_summary.json", summary)


def main(data_dir: str = "manual_labels", image_type: str = "W",
         configuration_options: Dict = None, base_overrides: Dict = None,
         save_root: str = "experiments", *, device="cuda") -> Dict:
    """Driver (model_configuration_experiment.py:425-496, seed 41)."""
    set_seed(41)
    base_config = {
        "name": "Model Configuration Test",
        "num_epochs": 50,
        "learning_rate": 1e-3,
        "weight_decay": 1e-8,
        "pretrained": True,
        "early_stopping_patience": 5,
        "early_stopping_min_delta": 0.001,
        "verbose": True,
        "save_plots": False,
        "data_dir": data_dir,
        "image_type": image_type,
        "test_size": 0.3,
        "n_splits": 5,
        "random_state": 41,
        "augmentations_per_image": 10,
        "img_size": (128, 128),
        "loss_fn": "bce",
    }
    base_config.update(base_overrides or {})
    if configuration_options is None:
        configuration_options = {
            "backbone": ["resnet34", "resnet50"],
            "use_attention": [True, False],
            "batch_size": [2, 4],
        }

    save_dir = os.path.join(save_root, f"model_configuration_{timestamp()}")
    print("=" * 60)
    print("MODEL CONFIGURATION EXPERIMENT")
    for option, values in configuration_options.items():
        print(f"  {option}: {values}")
    print(f"Results will be saved to: {save_dir}")
    print("=" * 60)

    experiment = ModelConfigurationExperiment(base_config,
                                              configuration_options,
                                              device=device)
    results = experiment.run_model_comparison()
    experiment.save_results(save_dir)
    draw_figure(experiment.plot_results, save_dir)
    print(f"\n{'='*60}\nMODEL CONFIGURATION EXPERIMENT COMPLETE!\n{'='*60}")
    return results


if __name__ == "__main__":
    # `python -m segtpu_torch.experiments.model_configuration` — the
    # analog of the reference's `python model_configuration_experiment.py`
    import sys
    if len(sys.argv) > 1:
        sys.exit("this entry runs the reference defaults and takes no "
                 "flags; use `python -m segtpu_torch.cli --experiment "
                 "model_configuration ...` instead")
    main()
