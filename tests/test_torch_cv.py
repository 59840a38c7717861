"""The port's K-fold harness (segtpu_torch.eval.cross_validation) against
the JAX package's, on one synthetic directory of TIFFs, on the CPU.

Each package's ``cross_validation.train_model`` is replaced by a recorder
that notes what the harness asked for (the folds, as indices into the
dataset, and the per-fold config, optimizer and scheduler) and returns
metrics made from those indices, so both harnesses must agree exactly:
the same folds, configs, scheduler arguments, summaries and resume files.
Then real runs of the port's harness (resnet_tiny, 32², 2 folds),
sequential and with ``fold_parallel=True``.
"""

import json
import os

import numpy as np
import pytest
import torch

from segtpu.eval import cross_validation as jax_cv
from segtpu_torch.data import make_synthetic_dataset
from segtpu_torch.eval import cross_validation as cv

S = 32
CONFIGS = [{"name": "Model A", "backbone": "resnet_tiny",
            "use_attention": True, "img_size": (S, S), "num_epochs": 4,
            "learning_rate": 3e-4, "weight_decay": 1e-6, "seed": 5},
           {"name": "Model B/2", "backbone": "resnet_tiny",
            "use_attention": False, "img_size": (S, S), "num_epochs": 2}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cv-data"))
    make_synthetic_dataset(root, n_images=11, image_type="W",
                           raw_size=(40, 56), seed=3)
    make_synthetic_dataset(root, n_images=2, image_type="B",
                           raw_size=(40, 56), seed=4)
    return root


class Recorder:
    """Stands in for ``train_model``: records each call by the dataset
    indices of its images and returns metrics made from them."""

    def __init__(self):
        self.calls = []
        self.lookup = {}

    def index(self, validator, img_size):
        ci, _ = validator._canonical(img_size)
        self.lookup = {ci[i].tobytes(): i for i in range(len(ci))}
        assert len(self.lookup) == len(ci)      # the frames are distinct

    def __call__(self, model=None, train_images=(), train_masks=(),
                 val_images=(), val_masks=(), criterion=None,
                 optimizer=None, scheduler=None, num_epochs=50,
                 config=None, augmentations_per_image=0, save_plots=True,
                 **kw):
        tr = [self.lookup[a.tobytes()] for a in train_images]
        va = [self.lookup[a.tobytes()] for a in val_images]
        self.calls.append(dict(
            train=tr, val=va, model=model, criterion=criterion,
            optimizer=optimizer, num_epochs=num_epochs,
            augmentations=augmentations_per_image, save_plots=save_plots,
            config={k: v for k, v in config.items()},
            scheduler={k: getattr(scheduler, k) for k in (
                "lr", "mode", "factor", "patience", "threshold", "min_lr")}))
        iou = (sum(va) + 1.0) / (sum(tr) + len(va) + 7.0)
        metrics = {"iou": iou, "f1": 2 * iou / (1 + iou),
                   "precision": len(va) / (len(tr) + 1.0),
                   "recall": float(np.mean(va)) / 11.0,
                   "accuracy": 1.0 - iou / 3, "loss": float(sum(tr)) / 99}
        return {"final_val_metrics": metrics, "best_iou": iou + 0.125}


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k != "training_time"}
    if isinstance(obj, (list, tuple)):
        return [_strip_times(v) for v in obj]
    return obj


def _run_both(monkeypatch, make, run):
    """``run(make(pkg))`` for the JAX package and the port, each with its
    own recorder; returns ((result, calls) of JAX, of the port)."""
    out = []
    for pkg, kw in ((jax_cv, {}), (cv, {"device": "cpu"})):
        rec = Recorder()
        monkeypatch.setattr(pkg, "train_model", rec)
        obj = make(pkg, kw)
        rec.index(getattr(obj, "cv", obj), (S, S))
        out.append((run(obj), rec.calls))
    return out


def test_cross_validator_matches_jax(monkeypatch, data_dir):
    (want, wcalls), (got, gcalls) = _run_both(
        monkeypatch,
        lambda pkg, kw: pkg.CrossValidator(
            data_dir, "W", n_splits=3, random_state=7,
            augmentations_per_image=2, verbose=False, **kw),
        lambda v: v.compare_multiple_models([(None, c) for c in CONFIGS]))
    assert len(gcalls) == 6
    assert gcalls == wcalls
    assert [c["config"]["seed"] for c in gcalls] == [5, 1005, 2005,
                                                     0, 1000, 2000]
    assert all(c["config"]["verbose"] is False for c in gcalls)
    assert _strip_times(got) == _strip_times(want)
    assert got["cv_folds_used"] == 3
    for res in got["individual_results"].values():
        assert all(f["training_time"] >= 0 for f in res["fold_results"])


def test_model_comparator_matches_jax(monkeypatch, data_dir):
    def run(comp):
        return (comp.train_indices, comp.test_indices,
                comp.run_cv_comparison([(None, c) for c in CONFIGS]),
                comp.evaluate_generalization([(None, c) for c in CONFIGS]))

    (want, wcalls), (got, gcalls) = _run_both(
        monkeypatch,
        lambda pkg, kw: pkg.ModelComparator(
            data_dir, "W", test_size=0.3, n_splits=2, random_state=41,
            augmentations_per_image=1, verbose=True, **kw), run)
    assert len(gcalls) == 6 and gcalls == wcalls
    assert got[0] == want[0] and got[1] == want[1] and len(got[1]) == 4
    # the held-out runs train on the whole train split, validate on test
    assert sorted(gcalls[-1]["train"]) == sorted(got[0])
    assert gcalls[-1]["val"] == got[1]
    assert _strip_times(got[2:]) == _strip_times(want[2:])


def test_resume_files_match_jax(monkeypatch, data_dir, tmp_path):
    cfg = dict(CONFIGS[1])
    files = []
    for pkg, kw in ((jax_cv, {}), (cv, {"device": "cpu"})):
        rec = Recorder()
        monkeypatch.setattr(pkg, "train_model", rec)
        d = str(tmp_path / pkg.__name__)
        v = pkg.CrossValidator(data_dir, "W", n_splits=2, verbose=False,
                               resume_dir=d, **kw)
        rec.index(v, (S, S))
        first = v.cross_validate_single_model(None, cfg)
        again = v.cross_validate_single_model(None, cfg)
        assert len(rec.calls) == 2              # the second run resumed
        assert _strip_times(again) == _strip_times(first)
        names = sorted(os.listdir(d))
        files.append((names, [_strip_times(json.load(open(
            os.path.join(d, n)))) for n in names]))
    assert files[1] == files[0]
    assert files[1][0] == ["Model_B_2_fold0.json", "Model_B_2_fold1.json"]


def test_quick_helpers_match_jax(monkeypatch, data_dir):
    """quick_model_comparison (with generalization) and quick_cv; the
    recorder indexes the frames of a validator on the same directory."""
    out = []
    for pkg, kw in ((jax_cv, {}), (cv, {"device": "cpu"})):
        rec = Recorder()
        monkeypatch.setattr(pkg, "train_model", rec)
        rec.index(pkg.CrossValidator(data_dir, verbose=False, **kw), (S, S))
        out.append((pkg.quick_model_comparison(
            [(None, c) for c in CONFIGS], data_dir=data_dir, n_splits=2,
            include_generalization=True, **kw),
            pkg.quick_cv(None, CONFIGS[0], data_dir=data_dir, n_splits=3,
                         **kw), rec.calls))
    assert _strip_times(out[1]) == _strip_times(out[0])


def test_fold_parallel_is_not_ported(data_dir):
    """``fold_parallel=True`` is ported now: the harness trains the folds
    together and agrees with the sequential harness on the same folds
    within the JAX package's bar (tests/test_fold_parallel.py)."""
    cfg = {"name": "fp", "backbone": "resnet_tiny", "img_size": (S, S),
           "num_epochs": 1, "batch_size": 4, "loss_fn": "bce"}
    kw = dict(data_dir=data_dir, image_type="W", n_splits=2,
              random_state=3, augmentations_per_image=1, verbose=False,
              device="cpu")
    seq = cv.CrossValidator(**kw).cross_validate_single_model(None, cfg)
    par = cv.CrossValidator(fold_parallel=True,
                            **kw).cross_validate_single_model(None, cfg)
    assert par["cv_summary"].keys() == seq["cv_summary"].keys()
    for key in ("iou_mean", "loss_mean"):
        assert par["cv_summary"][key] == pytest.approx(
            seq["cv_summary"][key], abs=1e-2)


def test_cross_validator_trains_for_real(data_dir):
    v = cv.CrossValidator(data_dir, "W", n_splits=2,
                          augmentations_per_image=1, verbose=False,
                          device="cpu")
    res = v.cross_validate_single_model(None, {
        "name": "tiny", "backbone": "resnet_tiny", "img_size": (S, S),
        "num_epochs": 1, "batch_size": 4, "loss_fn": "bce"})
    assert len(res["fold_results"]) == 2
    s = res["cv_summary"]
    assert set(s) == {f"{m}_{a}" for m in ("precision", "recall", "f1",
                                           "iou", "accuracy", "loss")
                      for a in ("mean", "std")}
    assert all(np.isfinite(list(s.values())))
