"""Experiment launcher CLI (port of ``segtpu/cli.py``).

Reference parity: main.py:20-37 — the same four ``--experiment`` choices
and the JAX package's extra flags: --data-dir, --image-type, --save-root,
--quick (a small fixture-scale run for smoke tests) and --fold-parallel
(each CV's folds trained together, ``segtpu_torch/eval/fold_parallel.py``).
The port adds --device (default ``cuda``; ``cpu`` only when asked).

    python -m segtpu_torch.cli --experiment model_configuration --quick \\
        --data-dir manual_labels --save-root experiments
    python -m segtpu_torch.cli --experiment augmentation_selection --quick \\
        --fold-parallel
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Cell Segmentation Experiment Launcher (PyTorch/CUDA)")
    parser.add_argument(
        "--experiment", type=str, required=True,
        choices=["augmentation_selection", "augmentation_amount",
                 "loss_function", "model_configuration"],
        help="Which experiment to run")
    parser.add_argument("--data-dir", type=str, default="manual_labels")
    parser.add_argument("--image-type", type=str, default="W",
                        choices=["W", "B"])
    parser.add_argument("--quick", action="store_true",
                        help="Reduced epochs/folds smoke-scale run")
    parser.add_argument("--save-root", type=str, default="experiments")
    parser.add_argument("--fold-parallel", action="store_true",
                        help="Train each CV's folds together (one fetch "
                             "of metrics per window of epochs)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Device every model trains on")
    args = parser.parse_args(argv)

    quick_overrides = {"num_epochs": 3, "n_splits": 2} if args.quick else {}
    if args.fold_parallel:
        quick_overrides["fold_parallel"] = True

    if args.experiment == "augmentation_selection":
        from segtpu_torch.experiments.forward_selection import \
            run_augmentation_selection_experiment
        run_augmentation_selection_experiment(
            data_dir=args.data_dir,
            config_overrides={"image_type": args.image_type,
                              "fold_parallel": args.fold_parallel,
                              **({"num_epochs": 3} if args.quick else {})},
            cv_folds=2 if args.quick else 5,
            max_augmentations=2 if args.quick else 10,
            quick_evaluation=args.quick, save_root=args.save_root,
            device=args.device)
    elif args.experiment == "augmentation_amount":
        from segtpu_torch.experiments.augmentation_amount import \
            main as aug_main
        aug_main(data_dir=args.data_dir, image_type=args.image_type,
                 augmentation_amounts=[0, 1, 2] if args.quick else None,
                 base_overrides=quick_overrides, save_root=args.save_root,
                 device=args.device)
    elif args.experiment == "loss_function":
        from segtpu_torch.experiments.loss_comparison import \
            main as loss_main
        loss_main(data_dir=args.data_dir, image_type=args.image_type,
                  n_splits=2 if args.quick else 5,
                  base_overrides=quick_overrides or None,
                  save_root=args.save_root,
                  fold_parallel=args.fold_parallel, device=args.device)
    else:
        from segtpu_torch.experiments.model_configuration import \
            main as mc_main
        mc_main(data_dir=args.data_dir, image_type=args.image_type,
                configuration_options=(
                    {"backbone": ["resnet34"], "use_attention": [True, False],
                     "batch_size": [4]} if args.quick else None),
                base_overrides=quick_overrides or None,
                save_root=args.save_root, device=args.device)


if __name__ == "__main__":
    main()
