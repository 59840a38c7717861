"""The experiment drivers of the port: the model-configuration grid, the
loss comparison, the augmentation-amount sweep and the augmentation
forward selection."""

from segtpu_torch.experiments.augmentation_amount import \
    main as run_augmentation_amount
from segtpu_torch.experiments.forward_selection import (
    AugmentationSelector, run_augmentation_selection_experiment)
from segtpu_torch.experiments.loss_comparison import \
    main as run_loss_function
from segtpu_torch.experiments.model_configuration import \
    main as run_model_configuration
