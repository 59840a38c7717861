"""Fold construction: KFold, GroupKFold and the train/test split (port of
``segtpu/eval/folds.py``).

The JAX package calls scikit-learn (the reference's folds:
cross_validation.py:63, forward_selection_integration.py:425-450,
cross_validation.py:317-321). The port imports no scikit-learn: each
function below is numpy that returns exactly what scikit-learn 1.9
returns for the same arguments, in the same order, so a sweep on the card
trains on the reference's folds.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

Folds = List[Tuple[np.ndarray, np.ndarray]]


def _check_splits(n_splits: int, n: int, what: str) -> None:
    if int(n_splits) != n_splits or n_splits < 2:
        raise ValueError(f"n_splits must be an integer of at least 2; got "
                         f"{n_splits}")
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits="
                         f"{n_splits} greater than the number of {what}: "
                         f"{n}.")


def _from_test_folds(n: int, tests) -> Folds:
    """(train, validation) pairs, both in index order, from each fold's
    validation indices (``BaseCrossValidator.split``)."""
    out = []
    for te in tests:
        mask = np.zeros(n, bool)
        mask[te] = True
        idx = np.arange(n)
        out.append((idx[~mask], idx[mask]))
    return out


def kfold_split(n: int, n_splits: int, shuffle: bool = True,
                random_state: int = 42) -> Folds:
    """``sklearn.model_selection.KFold(n_splits, shuffle, random_state)
    .split(range(n))``: the indices shuffled by
    ``RandomState(random_state).shuffle``, cut into n_splits runs of
    n // n_splits (the first n % n_splits one longer)."""
    _check_splits(n_splits, n, "samples")
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(random_state).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return _from_test_folds(n, (idx[a:b] for a, b in zip(bounds[:-1],
                                                          bounds[1:])))


def group_kfold_split(groups: Sequence, n_splits: int) -> Folds:
    """``sklearn.model_selection.GroupKFold(n_splits).split(X, groups=
    groups)``: no group straddles train and validation. Groups go, largest
    first (ties: the last of ``np.unique``'s order first), each to the
    fold with the fewest samples so far (ties: the first such fold)."""
    groups = np.asarray(groups)
    uniq, group_idx = np.unique(groups, return_inverse=True)
    _check_splits(n_splits, len(uniq), "groups")
    counts = np.bincount(group_idx)
    order = np.argsort(counts, kind="stable")[::-1]
    per_fold = np.zeros(n_splits)
    fold_of = np.zeros(len(uniq))
    for g in order:
        f = np.argmin(per_fold)
        per_fold[f] += counts[g]
        fold_of[g] = f
    of_sample = fold_of[group_idx]
    return _from_test_folds(len(groups), (np.where(of_sample == f)[0]
                                          for f in range(n_splits)))


def train_test_split_indices(n: int, test_size: float = 0.2,
                             random_state: int = 42
                             ) -> Tuple[List[int], List[int]]:
    """``sklearn.model_selection.train_test_split(list(range(n)),
    test_size=test_size, random_state=random_state)``: a
    ``RandomState(random_state).permutation(n)`` whose first
    ⌈n·test_size⌉ entries are the test set, the rest the training set."""
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be in (0, 1); got {test_size}")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} the "
                         f"training set would be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return [int(i) for i in perm[n_test:]], [int(i) for i in perm[:n_test]]
