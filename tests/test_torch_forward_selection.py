"""The port's augmentation forward selection
(segtpu_torch.experiments.forward_selection) against the JAX package's
(segtpu.experiments.forward_selection), on the CPU, on one synthetic
directory of TIFFs:

- the greedy search, with ``_evaluate_augmentation_set`` replaced by the
  same score table in both packages: byte-equal ``results.json``,
  including a gain exactly at the threshold (accepted) and a search that
  converges;
- the folds and each fold's data: the same grouped folds, the originals
  first and bit for bit, then 5 copies per image (here horizontal flips
  gated at p = 0.7, so each copy is its original or its mirror);
- ``_evaluate_folds_parallel``: the same config, seeds and ``auto_bias``
  handed to ``train_folds_parallel``, and the same validation data;
- the leakage guard; then one real tiny search, sequential and
  fold-parallel (resnet_tiny, 32², 2 grouped folds, 1 epoch).
"""

import json
import os

import numpy as np
import pytest
import torch

from segtpu.eval import fold_parallel as jax_fp
from segtpu.experiments import forward_selection as jax_fs
from segtpu_torch.data import make_synthetic_dataset
from segtpu_torch.eval import fold_parallel as fp
from segtpu_torch.experiments import forward_selection as fs

S = 32
BASE = {"image_type": "W", "backbone": "resnet_tiny", "img_size": (S, S),
        "batch_size": 2, "num_epochs": 1, "seed": 42, "loss_fn": "focal",
        "use_attention": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fs-data"))
    make_synthetic_dataset(root, n_images=6, image_type="W",
                           raw_size=(40, 56), seed=5)
    return root


def _narrow(monkeypatch, names):
    for mod in (jax_fs, fs):
        monkeypatch.setattr(mod, "AUGMENTATION_CANDIDATES", {
            k: v for k, v in mod.AUGMENTATION_CANDIDATES.items()
            if k in names})


# Scores per candidate set (in quarters and eighths: exact in binary).
TABLES = {
    "edge": {(): 0.5, ("a",): 0.75, ("b",): 0.625, ("c",): 0.5,
             ("a", "b"): 0.875, ("a", "c"): 0.75},
    "converged": {(): 0.5, ("a",): 0.625, ("b",): 0.5, ("c",): 0.25},
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_search_and_json_match_jax(monkeypatch, data_dir, tmp_path, table):
    """Threshold 0.25: in "edge" round 1 gains exactly 0.25 (accepted:
    the search stops only below the threshold) and round 2 gains 0.125
    (stops); in "converged" the best gain is 0.125."""
    names = {"horizontal_flip": "a", "vertical_flip": "b", "transpose": "c"}
    _narrow(monkeypatch, names)
    scores = TABLES[table]
    blobs = []
    for pkg, kw in ((jax_fs, {}), (fs, {"device": "cpu"})):
        monkeypatch.setattr(
            pkg.AugmentationSelector, "_evaluate_augmentation_set",
            lambda self, augs: scores[tuple(names[a] for a in augs)])
        root = str(tmp_path / pkg.__name__)
        results, pipeline = pkg.run_augmentation_selection_experiment(
            data_dir, dict(BASE), improvement_threshold=0.25,
            max_augmentations=3, cv_folds=2, save_root=root, **kw)
        with open(os.path.join(root, "augmentation_selection_results",
                               "results.json"), "rb") as f:
            blobs.append(f.read())
        assert [t[1] for t in pipeline.steps] == [
            0.5 if a in ("horizontal_flip", "vertical_flip") else 0.3
            for a in results["selected_augmentations"]]
    assert blobs[1] == blobs[0]
    back = json.loads(blobs[1])
    assert set(back) == {"selected_augmentations", "final_score",
                         "baseline_score", "total_improvement",
                         "selection_history", "config"}
    assert back["selected_augmentations"] == (
        ["horizontal_flip"] if table == "edge" else [])


def test_fold_data_matches_jax(data_dir):
    sel = [pkg.AugmentationSelector(dict(BASE), data_dir, cv_folds=3, **kw)
           for pkg, kw in ((jax_fs, {}), (fs, {"device": "cpu"}))]
    assert sel[1].base_names == sel[0].base_names
    assert sel[1].augmentation_candidates == sel[0].augmentation_candidates
    folds = jax_fs.group_kfold_split(sel[0].base_names, 3)
    as_lists = lambda fl: [[list(map(int, a)) for a in f] for f in fl]
    assert as_lists(fs.group_kfold_split(sel[1].base_names, 3)) == \
        as_lists(folds)
    tr, va = (np.asarray(i) for i in folds[0])
    n = len(tr)
    want = [np.asarray(a) for a in sel[0]._fold_data(tr, va,
                                                     ["horizontal_flip"])]
    got = [torch.as_tensor(a).numpy() for a in sel[1]._fold_data(
        tr, va, ["horizontal_flip"])]
    assert [a.shape for a in got] == [a.shape for a in want]
    assert got[0].shape[0] == 6 * n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:n], w[:n])    # originals first
    for imgs, masks in ((got[0], got[1]), (want[0], want[1])):
        assert set(np.unique(masks[n:])) <= {0, 1}
        for c in range(n, 6 * n):
            o = c % n
            assert (np.array_equal(imgs[c], imgs[o])
                    or np.array_equal(imgs[c], imgs[o][:, ::-1]))
    plain = sel[1]._fold_data(tr, va, [])
    assert len(plain[0]) == n


def test_evaluate_folds_parallel_hands_over_what_jax_does(monkeypatch,
                                                          data_dir):
    seen = []

    def recorder(arrays, config, engine=None, seeds=None, auto_bias=True,
                 **kw):
        seen.append(dict(config=config, seeds=seeds, auto_bias=auto_bias,
                         sizes=[(a[0].shape[0], a[2].shape[0])
                                for a in arrays],
                         val_masks=[np.asarray(a[3]).reshape(-1)
                                    for a in arrays]))
        return [{"best_iou": 0.25 * (k + 1)} for k in range(len(arrays))]

    monkeypatch.setattr(jax_fp, "train_folds_parallel", recorder)
    monkeypatch.setattr(fp, "train_folds_parallel", recorder)
    cfg = dict(BASE, fold_parallel=True)
    scores = []
    for pkg, kw in ((jax_fs, {}), (fs, {"device": "cpu"})):
        sel = pkg.AugmentationSelector(dict(cfg), data_dir, cv_folds=2,
                                       quick_evaluation=True, **kw)
        folds = pkg.group_kfold_split(sel.base_names, 2)
        scores.append(sel._evaluate_folds_parallel(folds,
                                                   ["horizontal_flip"]))
    assert scores[1] == scores[0] == [0.25, 0.5]
    want, got = seen
    assert got["config"] == want["config"]
    assert got["config"]["num_epochs"] == 15       # the quick cap
    assert (got["seeds"], got["auto_bias"]) == (want["seeds"], False)
    assert got["sizes"] == want["sizes"]
    for g, w in zip(got["val_masks"], want["val_masks"]):
        np.testing.assert_array_equal(g, w)


def test_leakage_guard(monkeypatch, data_dir):
    sel = fs.AugmentationSelector(dict(BASE), data_dir, cv_folds=2,
                                  device="cpu")
    monkeypatch.setattr(fs, "group_kfold_split",
                        lambda names, k: [([0, 1, 2], [2, 3])])
    with pytest.raises(AssertionError, match="Data leakage"):
        sel._evaluate_augmentation_set([])


@pytest.mark.parametrize("fold_parallel", [False, True],
                         ids=["sequential", "fold-parallel"])
def test_real_search(monkeypatch, data_dir, tmp_path, fold_parallel):
    _narrow(monkeypatch, {"horizontal_flip"})
    results, _ = fs.run_augmentation_selection_experiment(
        data_dir, dict(BASE, fold_parallel=fold_parallel),
        max_augmentations=1, cv_folds=2, quick_evaluation=False,
        save_root=str(tmp_path), device="cpu")
    with open(tmp_path / "augmentation_selection_results"
              / "results.json") as f:
        back = json.load(f)
    assert back["config"]["fold_parallel"] is fold_parallel
    assert 0.0 <= back["baseline_score"] <= 1.0
    assert 0.0 <= back["final_score"] <= 1.0
    assert back["selected_augmentations"] in ([], ["horizontal_flip"])
    assert back["final_score"] >= back["baseline_score"]
