"""The port's fold construction (segtpu_torch.eval.folds, numpy only)
against the JAX package's (segtpu.eval.folds), which calls scikit-learn
here: the same folds, in the same order, for every n, k and seed
hypothesis draws."""

import ast
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from segtpu.eval import folds as jax_folds
from segtpu_torch.eval import folds

ROOT = Path(__file__).resolve().parent.parent


def _same_folds(got, want):
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def _outcome(fn, *args, **kw):
    """fn's result, or the type of the exception it raised."""
    try:
        return fn(*args, **kw)
    except ValueError:
        return ValueError


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 60), k=st.integers(2, 8),
       seed=st.integers(0, 2 ** 31 - 1), shuffle=st.booleans())
def test_kfold_split_equals_sklearn(n, k, seed, shuffle):
    want = _outcome(jax_folds.kfold_split, n, k, shuffle=shuffle,
                    random_state=seed)
    got = _outcome(folds.kfold_split, n, k, shuffle=shuffle,
                   random_state=seed)
    if want is ValueError:
        assert got is ValueError
        return
    _same_folds(got, want)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 60),
       test_size=st.floats(0.05, 0.95, allow_nan=False),
       seed=st.integers(0, 2 ** 31 - 1))
def test_train_test_split_equals_sklearn(n, test_size, seed):
    want = _outcome(jax_folds.train_test_split_indices, n,
                    test_size=test_size, random_state=seed)
    got = _outcome(folds.train_test_split_indices, n, test_size=test_size,
                   random_state=seed)
    assert got == want
    if want is not ValueError:
        assert all(type(i) is int for i in got[0] + got[1])


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(groups=st.lists(st.integers(0, 9), min_size=1, max_size=40),
       k=st.integers(2, 6))
def test_group_kfold_split_equals_sklearn(groups, k):
    """Ties in the group sizes included: sklearn takes the last of them
    first (a reversed stable argsort), which ``np.argsort(-counts)`` does
    not reproduce."""
    want = _outcome(jax_folds.group_kfold_split, groups, k)
    got = _outcome(folds.group_kfold_split, groups, k)
    if want is ValueError:
        assert got is ValueError
        return
    _same_folds(got, want)


def test_known_folds():
    """The cases that tell sklearn's order from the JAX package's numpy
    fallback: KFold's validation indices sorted, and GroupKFold's ties."""
    va = folds.kfold_split(23, 5, random_state=42)[0][1]
    np.testing.assert_array_equal(va, [0, 8, 9, 15, 17])
    ties = folds.group_kfold_split([0, 0, 1, 1, 2, 2, 3], 3)
    assert [v.tolist() for _, v in ties] == [[4, 5, 6], [2, 3], [0, 1]]
    with pytest.raises(ValueError, match="number of groups"):
        folds.group_kfold_split([0, 0, 1], 3)


def test_folds_module_imports_no_sklearn():
    tree = ast.parse((ROOT / "segtpu_torch/eval/folds.py").read_text())
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not any(n.split(".")[0] == "sklearn" for n in names), names
