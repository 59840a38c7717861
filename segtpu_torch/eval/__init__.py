"""Folds, K-fold cross-validation, fold-parallel training and the model
comparator of the port."""

from segtpu_torch.eval.cross_validation import (CrossValidator,
                                                ModelComparator, quick_cv,
                                                quick_model_comparison)
from segtpu_torch.eval.fold_parallel import (cv_train_folds_parallel,
                                             train_folds_parallel)
from segtpu_torch.eval.folds import (group_kfold_split, kfold_split,
                                     train_test_split_indices)
