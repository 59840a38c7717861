"""The port's experiment layer (segtpu_torch.core.config,
segtpu_torch.experiments.*, segtpu_torch.cli) against the JAX package's,
on the CPU.

Each experiment's ``main()`` runs end to end on a tiny synthetic
directory of TIFFs in both packages, with each package's ``cross_validation
.train_model`` replaced by a recorder that returns metrics made from the
call (so no model trains): the JSON artefacts must carry the same keys.
Then the figure fallback (matplotlib blocked) and the CLI's parsing.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from segtpu import cli as jax_cli
from segtpu.core import config as jax_config
from segtpu.eval import cross_validation as jax_cv
from segtpu.experiments import augmentation_amount as jax_aug
from segtpu.experiments import forward_selection as jax_fs
from segtpu.experiments import loss_comparison as jax_loss
from segtpu.experiments import model_configuration as jax_mc
from segtpu_torch import cli
from segtpu_torch.core import config
from segtpu_torch.data import make_synthetic_dataset
from segtpu_torch.eval import cross_validation as cv
from segtpu_torch.experiments import augmentation_amount as aug
from segtpu_torch.experiments import forward_selection as fs
from segtpu_torch.experiments import loss_comparison as loss
from segtpu_torch.experiments import model_configuration as mc
from segtpu_torch.experiments.common import to_jsonable

TINY = {"img_size": (32, 32), "num_epochs": 1, "n_splits": 2}
PACKAGES = ((jax_cv, jax_mc, jax_loss, jax_aug, {}),
            (cv, mc, loss, aug, {"device": "cpu"}))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exp-data"))
    make_synthetic_dataset(root, n_images=8, image_type="W",
                           raw_size=(40, 56), seed=5)
    return root


def _recorder(model=None, train_images=(), train_masks=(), val_images=(),
              val_masks=(), config=None, augmentations_per_image=0, **kw):
    """train_model's stand-in: metrics from the call's sizes and seed."""
    n_tr, n_va = len(train_images), len(val_images)
    iou = (n_va + int(config.get("seed", 0)) % 7) / (n_tr + 11.0)
    m = {"iou": iou, "f1": iou / 2, "precision": 0.5, "recall": n_va / 9,
         "accuracy": 0.9, "loss": 1.0 / (1 + augmentations_per_image)}
    return {"final_val_metrics": m, "best_iou": iou + 0.1}


def _keys(obj):
    """The key structure of a JSON value."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


def _artefacts(root):
    """{file name: key structure} of every JSON an experiment wrote under
    ``root``, and the PNG names."""
    out, pngs = {}, []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    out[f] = _keys(json.load(fh))
            elif f.endswith(".png"):
                pngs.append(f)
    return out, sorted(pngs)


def _no_plots(monkeypatch, mc_mod, loss_mod, aug_mod):
    monkeypatch.setattr(mc_mod.ModelConfigurationExperiment, "plot_results",
                        lambda self, save_dir=None: None)
    monkeypatch.setattr(aug_mod.AugmentationAmountExperiment,
                        "plot_results", lambda self, save_dir=None: None)
    monkeypatch.setattr(loss_mod, "plot_cv_results", lambda *a: None)
    monkeypatch.setattr(loss_mod, "plot_generalization_results",
                        lambda *a: None)


def _drivers(data_dir, save_root, mc_mod, loss_mod, aug_mod, kw):
    """Each experiment's main() at a tiny size; returns their results."""
    return (
        mc_mod.main(data_dir, "W", configuration_options={
            "backbone": ["resnet34", "resnet50"], "use_attention": [True],
            "batch_size": [2, 4]}, base_overrides=TINY,
            save_root=save_root, **kw),
        loss_mod.main(data_dir, "W", n_splits=2,
                      base_overrides={"img_size": (32, 32),
                                      "num_epochs": 1},
                      save_root=save_root, **kw),
        aug_mod.main(data_dir, "W", augmentation_amounts=[0, 2],
                     base_overrides=TINY, save_root=save_root, **kw))


def test_expand_grid_and_set_seed_match_jax():
    base = {"lr": 1e-3, "img_size": (32, 32)}
    opts = {"backbone": ["resnet34", "resnet50"], "use_attention": [True,
                                                                    False],
            "batch_size": [2, 4], "loss_fn": ["bce"]}
    assert config.expand_grid(base, opts) == jax_config.expand_grid(base,
                                                                    opts)
    assert len(config.expand_grid(base, opts)) == 8
    assert config.merge_config(base, lr=1) == jax_config.merge_config(base,
                                                                      lr=1)
    assert config.cfg_get(None, "a", 3) == jax_config.cfg_get(None, "a", 3)
    draws = []
    for set_seed in (jax_config.set_seed, config.set_seed):
        set_seed(41)
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]


def test_to_jsonable_turns_tensors_into_numbers():
    got = to_jsonable({"a": torch.tensor(1.5), "b": torch.ones(2, 2),
                       3: (np.float32(2.0), np.arange(2), torch.tensor(7))})
    assert got == {"a": 1.5, "b": [[1.0, 1.0], [1.0, 1.0]],
                   "3": [2.0, [0, 1], 7]}
    json.dumps(got)


def test_drivers_write_the_jax_drivers_json_keys(monkeypatch, data_dir,
                                                 tmp_path):
    got = []
    for cv_mod, mc_mod, loss_mod, aug_mod, kw in PACKAGES:
        monkeypatch.setattr(cv_mod, "train_model", _recorder)
        _no_plots(monkeypatch, mc_mod, loss_mod, aug_mod)
        root = str(tmp_path / mc_mod.__name__.split(".")[0])
        res = _drivers(data_dir, root, mc_mod, loss_mod, aug_mod, kw)
        got.append((_artefacts(root)[0], [_keys(to_jsonable(
            {k: v for k, v in r.items() if k != "save_dir"}))
            for r in res]))
    (want_files, want_res), (files, res) = got
    assert set(files) == {
        "model_configuration_results.json",
        "model_configuration_summary.json", "cv_results.json",
        "generalization_results.json", "augmentation_amount_results.json",
        "augmentation_amount_summary.json"}
    assert files == want_files
    assert res == want_res


@pytest.mark.parametrize("experiment", ["model_configuration",
                                        "loss_function",
                                        "augmentation_amount"])
def test_drivers_without_matplotlib_write_every_json(monkeypatch, capsys,
                                                     data_dir, tmp_path,
                                                     experiment):
    """The card's machine has no matplotlib: the figure is not drawn, one
    line says so, and every JSON artefact is written."""
    monkeypatch.setattr(cv, "train_model", _recorder)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    root = str(tmp_path)
    argv = ["--experiment", experiment, "--quick", "--data-dir", data_dir,
            "--save-root", root, "--device", "cpu"]
    cli.main(argv)
    files, pngs = _artefacts(root)
    lines = capsys.readouterr().out.splitlines()
    drawn = lines.count("figure not drawn: matplotlib is not installed")
    assert pngs == []
    assert drawn == (2 if experiment == "loss_function" else 1)
    assert len(files) == 2


def test_drivers_draw_their_figures(monkeypatch, data_dir, tmp_path):
    monkeypatch.setattr(cv, "train_model", _recorder)
    root = str(tmp_path)
    res = _drivers(data_dir, root, mc, loss, aug, {"device": "cpu"})
    assert all(r for r in res)
    assert _artefacts(root)[1] == [
        "augmentation_amount_results.png", "cv_loss_comparison.png",
        "generalization_loss_comparison.png",
        "model_configuration_results.png"]


def _record_mains(monkeypatch, mc_mod, loss_mod, aug_mod, fs_mod):
    calls = []
    for mod in (mc_mod, loss_mod, aug_mod):
        monkeypatch.setattr(mod, "main", lambda _m=mod, **kw: calls.append(
            (_m.__name__.rsplit(".", 1)[-1], kw)))
    monkeypatch.setattr(
        fs_mod, "run_augmentation_selection_experiment",
        lambda **kw: calls.append(("forward_selection", kw)))
    return calls


@pytest.mark.parametrize("fold_parallel", [False, True],
                         ids=["sequential", "fold-parallel"])
@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
@pytest.mark.parametrize("experiment", ["model_configuration",
                                        "loss_function",
                                        "augmentation_amount",
                                        "augmentation_selection"])
def test_cli_calls_the_driver_as_the_jax_cli(monkeypatch, experiment,
                                             quick, fold_parallel):
    argv = ["--experiment", experiment, "--data-dir", "d",
            "--image-type", "B", "--save-root", "out"] + (
        ["--quick"] if quick else []) + (
        ["--fold-parallel"] if fold_parallel else [])
    want = _record_mains(monkeypatch, jax_mc, jax_loss, jax_aug, jax_fs)
    jax_cli.main(argv)
    got = _record_mains(monkeypatch, mc, loss, aug, fs)
    cli.main(argv)
    (name, kw), = got
    assert kw.pop("device") == "cuda"
    assert [(name, kw)] == want


def test_cli_refuses_what_is_not_ported(monkeypatch):
    """Nothing of the JAX CLI is left out now: ``augmentation_selection``
    and ``--fold-parallel`` reach their drivers (the fold-parallel switch
    in the config or the argument the JAX CLI gives); an unknown
    experiment still exits."""
    calls = _record_mains(monkeypatch, mc, loss, aug, fs)
    cli.main(["--experiment", "augmentation_selection", "--quick",
              "--fold-parallel", "--device", "cpu"])
    cli.main(["--experiment", "loss_function", "--fold-parallel"])
    cli.main(["--experiment", "model_configuration", "--fold-parallel"])
    (sel, skw), (lossf, lkw), (mcn, mkw) = calls
    assert sel == "forward_selection" and skw["device"] == "cpu"
    assert skw["config_overrides"]["fold_parallel"] is True
    assert (skw["cv_folds"], skw["max_augmentations"],
            skw["quick_evaluation"]) == (2, 2, True)
    assert lossf == "loss_comparison" and lkw["fold_parallel"] is True
    assert mkw["base_overrides"] == {"fold_parallel": True}
    with pytest.raises(SystemExit):
        cli.main(["--experiment", "bogus"])
