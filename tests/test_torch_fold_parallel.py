"""The port's fold-parallel training (segtpu_torch.eval.fold_parallel, the
engine's fold-parallel blocks, the functional optimizers) against the JAX
package's, on the CPU.

- The controllers: both packages' ``train_folds_parallel`` driven by a
  scripted engine that returns tabulated epoch totals (no model): under
  plateau, warmup, cosine and early stopping, for ``stream`` and
  ``vmap``, the same LR histories, best epochs and IoUs, epoch counts and
  sequence of dispatches and fetches.
- The slice as a whole: ``cv_train_folds_parallel``, 2 folds × 2 epochs,
  resnet_tiny with attention at 64², each fold's training set one image
  repeated (so that the shuffle order does not matter), the port's folds
  starting from the JAX package's per-fold init: per-epoch loss within
  rtol 1e-4, the other metrics within 1e-2, the same LR histories and
  best epochs. With SGD: Adam's first steps are sign-like, so in float32
  the two packages' gradients of a few near-zero entries part them by
  about 1e-4 of the loss after one step (Adam is held in float64 below);
  and at 64², since at 32² the bottom BatchNorm normalises the same
  value twice and its gradient follows the variance's rounding.
- The port on its own: ``stream`` equals sequential ``train_model`` per
  fold; the best weights of a best epoch inside a window; ``devices``;
  multiclass labels; the foreground-prior bias;
  ``CrossValidator(fold_parallel=True)`` (the ``vmap`` strategy's own
  tests are in test_torch_fold_vmap.py).
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from segtpu.eval import cross_validation as jax_cv
from segtpu.eval import fold_parallel as jax_fp
from segtpu.train.engine import TrainState as JaxTrainState
from segtpu.train.engine import get_engine as jax_get_engine
from segtpu_torch.data import make_synthetic_dataset
from segtpu_torch.eval import cross_validation as cv
from segtpu_torch.eval import fold_parallel as fp
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train.engine import StackedFolds, TrainEngine, TrainState
from segtpu_torch.train.loop import _materialize, train_model
from segtpu_torch.train.optim import ReduceLROnPlateau

S = 32
CFG = {"backbone": "resnet_tiny", "use_attention": True, "batch_size": 3,
       "img_size": (S, S), "learning_rate": 1e-3, "weight_decay": 1e-5,
       "loss_fn": "bce", "verbose": False, "save_plots": False, "seed": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(s, n=12):
    """Learnable canonical uint8 blob data (N, s, s)."""
    rng = np.random.default_rng(7)
    imgs = np.clip(rng.normal(80, 12, (n, s, s)), 0, 255).astype(np.uint8)
    masks = np.zeros((n, s, s), np.uint8)
    yy, xx = np.mgrid[0:s, 0:s]
    for i in range(n):
        cy, cx = rng.integers(s // 4, 3 * s // 4, 2)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < (s / 5) ** 2
        imgs[i][blob] = np.minimum(imgs[i][blob] + 120, 255)
        masks[i][blob] = 255
    return imgs, masks


@pytest.fixture(scope="module")
def canonical():
    return _blobs(S)


FOLDS = [(list(range(0, 8)), list(range(8, 12))),
         (list(range(4, 12)), list(range(0, 4)))]


# ----------------------------------------------------------- controllers
# Validation IoU per fold and epoch, in 64ths (exact in float32, so both
# packages' controllers see the same numbers).
IOU = [[8, 16, 24, 24, 24, 25, 25, 25, 25, 30, 30, 30, 31, 31],
       [4, 4, 20, 21, 21, 21, 40, 40, 40, 40, 40, 40, 41, 41],
       [2, 30, 30, 30, 30, 30, 30, 30, 31, 31, 31, 31, 31, 31]]
N_TR, N_VA = 4, 2
CASES = {
    "plateau": {"scheduler_patience": 1},
    "warmup": {"warmup_epochs": 3, "scheduler_patience": 2},
    "cosine": {"lr_schedule": "cosine", "early_stopping_patience": 4},
    "early": {"early_stopping_patience": 2,
              "early_stopping_min_delta": 0.01, "pipeline_epochs": 3},
}


def _totals(table, k, e, n):
    iou = table[k][e] / 64
    vec = [iou, iou / 2, iou / 4, iou, 1 - iou / 8, 1 - iou]
    return [v * n for v in vec]


class JaxScripted:
    """The JAX package's engine, scripted: a state is (fold, epoch), the
    totals of fold k's epoch e come from ``table[k][e]``."""

    def __init__(self, table=IOU):
        self.model = types.SimpleNamespace(n_classes=1, backbone="none")
        self.table = table
        self.log = []

    def init_state(self, key, shape, lr, wd):
        fold = int(jax.random.key_data(key)[-1]) // 1000
        return JaxTrainState({"fold": jnp.asarray(fold),
                              "epoch": jnp.asarray(0)}, {}, None)

    def run_fold_epoch_async(self, state, ti, tm, vi, vm, lr, key, b):
        k, e = int(state.params["fold"]), int(state.params["epoch"])
        self.log.append(("dispatch", k, e))
        nxt = state.replace(params={"fold": state.params["fold"],
                                    "epoch": jnp.asarray(e + 1)})
        return (nxt,
                jnp.asarray(_totals(self.table, k, e, N_TR), jnp.float32),
                jnp.asarray(_totals(self.table, k, e, N_VA), jnp.float32))

    def run_fold_epochs(self, states, tr_i, tr_m, va_i, va_m, lrs, keys, b):
        folds = np.asarray(states.params["fold"])
        e = int(np.asarray(states.params["epoch"])[0])
        self.log.append(("dispatch", -1, e))
        nxt = states.replace(params={"fold": states.params["fold"],
                                     "epoch": states.params["epoch"] + 1})
        return (nxt, jnp.asarray([_totals(self.table, k, e, N_TR)
                                  for k in folds], jnp.float32),
                jnp.asarray([_totals(self.table, k, e, N_VA)
                             for k in folds], jnp.float32))


class Counter(nn.Module):
    """A scripted fold's state: its fold and the epochs it ran, updated
    in place as an optimizer updates weights."""

    def __init__(self, fold):
        super().__init__()
        self.register_buffer("fold", torch.tensor(fold))
        self.register_buffer("epoch", torch.tensor(0))


class PortScripted:
    """The port's engine, scripted as ``JaxScripted``."""
    device = torch.device("cpu")
    n_classes = 1
    backbone = "none"

    def __init__(self, table=IOU):
        self.table = table
        self.log = []

    def init_state(self, gen, lr, wd):
        return TrainState(Counter(gen.initial_seed() // 1000))

    def run_fold_epoch_async(self, state, ti, tm, vi, vm, lr, gen, b):
        k, e = int(state.model.fold), int(state.model.epoch)
        self.log.append(("dispatch", k, e))
        state.model.epoch.add_(1)
        return (state, torch.tensor(_totals(self.table, k, e, N_TR)),
                torch.tensor(_totals(self.table, k, e, N_VA)))

    def stack_folds(self, states, wd):
        bufs = {n: torch.stack([s.model.state_dict()[n] for s in states])
                for n in ("fold", "epoch")}
        return StackedFolds({}, bufs, {}, states[0].model, wd)

    def run_fold_epochs(self, stack, tr_i, tr_m, va_i, va_m, lrs, gens, b):
        e = int(stack.buffers["epoch"][0])
        self.log.append(("dispatch", -1, e))
        stack.buffers["epoch"].add_(1)
        folds = stack.buffers["fold"].tolist()
        return (stack,
                torch.tensor([_totals(self.table, k, e, N_TR)
                              for k in folds]),
                torch.tensor([_totals(self.table, k, e, N_VA)
                              for k in folds]))

    def fold_state(self, stack, k, lr):
        model = Counter(0)
        model.load_state_dict(stack.fold_state_dict(k))
        return TrainState(model)


def _scripted_run(monkeypatch, pkg, engine, strategy, cfg):
    if pkg is jax_fp:
        real = jax.device_get
        monkeypatch.setattr(jax, "device_get", lambda x: (
            engine.log.append(("fetch",)), real(x))[1])
        arrays = [tuple(jnp.zeros((n, 2, 2, 1)) for n in
                        (N_TR, N_TR, N_VA, N_VA))] * 3
        kw = {}
    else:
        real = fp._fetch
        monkeypatch.setattr(fp, "_fetch", lambda x: (
            engine.log.append(("fetch",)), real(x))[1])
        arrays = [tuple(torch.zeros(n, 1, 2, 2) for n in
                        (N_TR, N_TR, N_VA, N_VA))] * 3
        kw = {"device": "cpu"}
    out = pkg.train_folds_parallel(arrays, cfg, engine=engine,
                                   strategy=strategy, **kw)
    monkeypatch.undo()
    return out, engine.log


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("strategy", ["stream", "vmap"])
def test_controllers_match_jax(monkeypatch, strategy, case):
    cfg = dict(CFG, loss_fn="combo", num_epochs=len(IOU[0]), **CASES[case])
    want, wlog = _scripted_run(monkeypatch, jax_fp, JaxScripted(), strategy,
                               cfg)
    got, glog = _scripted_run(monkeypatch, fp, PortScripted(), strategy,
                              cfg)
    assert glog == wlog
    if strategy == "stream":     # windows of several epochs, one fetch each
        assert glog.count(("fetch",)) < len(glog) - glog.count(("fetch",))
    for g, w in zip(got, want):
        assert g["lr_history"] == w["lr_history"]
        assert (g["best_epoch"], g["best_iou"]) == (w["best_epoch"],
                                                   w["best_iou"])
        assert g["val_metrics"] == w["val_metrics"]
        assert g["train_metrics"] == w["train_metrics"]
        assert g["final_val_metrics"] == w["final_val_metrics"]


def test_best_epoch_inside_a_window_gets_its_own_weights(monkeypatch):
    """A window of 4 epochs (the early stopper allows it) whose best epoch
    is its second: the fold gets back the weights after that epoch, not
    the window's last ones, though the optimizer (here: the scripted
    epoch counter) changes them in place."""
    cfg = dict(CFG, loss_fn="combo", num_epochs=4, pipeline_epochs=4,
               scheduler_patience=10, early_stopping_patience=10)
    engine = PortScripted([[8, 40, 30, 20]] * 3)
    (res, *_), log = _scripted_run(monkeypatch, fp, engine, "stream", cfg)
    assert log.count(("fetch",)) == 1 and len(log) == 3 * 4 + 1
    assert res["best_epoch"] == 1
    assert int(res["best_model_state"]["epoch"]) == 2
    assert int(res["state"].model.epoch) == 2


# ------------------------------------------------- the slice against JAX

def _port_init_from_jax(monkeypatch, cfg):
    """The port's ``init_state`` made to start each fold from the JAX
    package's init for the same seed (the generator's)."""
    jeng = jax_get_engine(cfg)

    def init_state(self, gen, lr, wd):
        st = jeng.init_state(jax.random.key(gen.initial_seed()),
                             (1, *cfg["img_size"], 1), lr, wd)
        model = self.build_model()
        model.load_state_dict(state_dict_from_jax(
            st.params, st.batch_stats, "resnet_tiny", True, device="cpu"))
        return TrainState(model, self.make_optimizer(model, lr, wd))

    monkeypatch.setattr(TrainEngine, "init_state", init_state)


@pytest.fixture(scope="module")
def jax_whole():
    ci, cm = _blobs(64)
    folds = [([0] * 4, [4, 5]), ([2] * 4, [7, 8])]
    cfg = dict(CFG, batch_size=2, num_epochs=2, img_size=(64, 64),
               optimizer="sgd", learning_rate=1e-2)
    return (ci, cm), folds, cfg, jax_fp.cv_train_folds_parallel(
        ci, cm, folds, cfg)


@pytest.mark.parametrize("strategy", ["stream", "vmap"])
def test_cv_train_folds_parallel_matches_jax(monkeypatch, jax_whole,
                                             strategy):
    (ci, cm), folds, cfg, want = jax_whole
    _port_init_from_jax(monkeypatch, cfg)
    got = fp.cv_train_folds_parallel(
        ci, cm, folds, dict(cfg, fold_parallel_strategy=strategy),
        device="cpu")
    for g, w in zip(got, want):
        assert g["lr_history"] == pytest.approx(w["lr_history"])
        assert g["best_epoch"] == w["best_epoch"]
        for key in ("train_metrics", "val_metrics"):
            assert len(g[key]) == len(w[key]) == 2
            for gm, wm in zip(g[key], w[key]):
                np.testing.assert_allclose(gm["loss"], wm["loss"],
                                           rtol=1e-4)
                for m in ("iou", "f1", "precision", "recall", "accuracy"):
                    np.testing.assert_allclose(gm[m], wm[m], atol=1e-2)


# ------------------------------------------------------ the port alone

def test_stream_equals_sequential_train_model(canonical):
    ci, cm = canonical
    cfg = dict(CFG, num_epochs=2)
    fp.reset_fetch_count()
    par = fp.cv_train_folds_parallel(ci, cm, FOLDS, cfg, device="cpu")
    assert fp.fetch_count() == 1        # one window of both epochs
    for k, (tr, va) in enumerate(FOLDS):
        seq = train_model(
            None, ci[tr], cm[tr], ci[va], cm[va],
            optimizer={"learning_rate": 1e-3, "weight_decay": 1e-5},
            scheduler=ReduceLROnPlateau(1e-3, "max", 0.5, 3, min_lr=1e-6),
            num_epochs=2, device="cpu", config=dict(cfg, seed=1000 * k))
        # the JAX test's tolerances (tests/test_fold_parallel.py)
        for key in ("val_metrics", "train_metrics"):
            for pm, sm in zip(par[k][key], seq[key]):
                assert abs(pm["loss"] - sm["loss"]) < 5e-3
                assert abs(pm["iou"] - sm["iou"]) < 2e-2
        assert par[k]["lr_history"] == pytest.approx(seq["lr_history"])
        assert par[k]["best_epoch"] == seq["best_epoch"]
        assert all(p.device.type == "cpu"
                   for p in par[k]["state"].model.parameters())


def test_devices_place_folds_and_change_nothing(canonical):
    ci, cm = canonical
    cfg = dict(CFG, num_epochs=1, use_attention=False)
    arrays = [_materialize(ci[tr], cm[tr], device="cpu")
              + _materialize(ci[va], cm[va], device="cpu")
              for tr, va in FOLDS]
    base = fp.train_folds_parallel(arrays, cfg, seeds=[0, 1000],
                                   device="cpu")
    placed = fp.train_folds_parallel(arrays, cfg, seeds=[0, 1000],
                                     devices=["cpu", "cpu"], device="cpu")
    for b, p in zip(base, placed):
        assert p["val_metrics"] == b["val_metrics"]
        assert p["lr_history"] == b["lr_history"]
    with pytest.raises(ValueError, match="strategy"):
        fp.train_folds_parallel(arrays, cfg, strategy="bogus", device="cpu")


def test_cv_fold_parallel_keeps_multiclass_labels(monkeypatch):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (6, S, S), np.uint8)
    masks = np.zeros((6, S, S), np.uint8)
    masks[:, 4:12, 4:12] = 1
    masks[:, 18:28, 18:28] = 2     # the label that binarising destroys
    captured = {}

    def fake_train(arrays, config, engine=None, seeds=None, **kw):
        captured["arrays"] = arrays
        return [{"val_metrics": [{"iou": 0.0}]} for _ in arrays]

    monkeypatch.setattr(fp, "train_folds_parallel", fake_train)
    cfg = dict(CFG, n_classes=3, loss_fn="ce_multiclass", num_epochs=1)
    fp.cv_train_folds_parallel(imgs, masks, [([0, 1, 2, 3], [4, 5])], cfg,
                               augmentations_per_image=1, device="cpu")
    tr_masks, va_masks = (captured["arrays"][0][i] for i in (1, 3))
    assert float(tr_masks.max()) == 2.0, "train labels binarised"
    assert set(torch.unique(va_masks).tolist()) == {0.0, 1.0, 2.0}


def test_fold_bias_prior_matches_jax():
    rng = np.random.default_rng(11)
    for share in (0.3, 0.0, 1.0):
        masks = (rng.random((5, S, S, 1)) < share).astype(np.float32)
        params = {"conv_final": {"bias": jnp.zeros((1,))}}
        want = jax_fp._fold_bias_prior(JaxTrainState(params, {}, None),
                                       jnp.asarray(masks))
        model = nn.Module()
        model.conv_final = nn.Conv2d(16, 1, 1)
        got = fp._fold_bias_prior(TrainState(model), torch.from_numpy(
            masks).permute(0, 3, 1, 2))
        # the JAX package takes the logit in float32, the port in float64
        # (as its train_model does)
        np.testing.assert_allclose(
            got.model.conv_final.bias.detach().numpy(),
            np.asarray(want.params["conv_final"]["bias"]), rtol=1e-4)


# ------------------------------------------------ the K-fold harness

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fp-data"))
    make_synthetic_dataset(root, n_images=8, image_type="W",
                           raw_size=(40, 56), seed=3)
    return root


def _recorder(calls):
    """``cv_train_folds_parallel``'s stand-in: metrics from the folds'
    sizes and original indices."""
    def run(ci, cm, folds, config, augmentations_per_image=0, engine=None,
            fold_ids=None, **kw):
        calls.append(dict(folds=[list(map(int, tr)) + list(map(int, va))
                                 for tr, va in folds],
                          fold_ids=list(fold_ids), seed=config["seed"],
                          augmentations=augmentations_per_image))
        out = []
        for (tr, va), k in zip(folds, fold_ids):
            iou = (len(va) + k) / (len(tr) + 9.0)
            m = {"iou": iou, "f1": iou / 2, "precision": 0.5,
                 "recall": k / 7, "accuracy": 0.9, "loss": 1.0 / (k + 2)}
            out.append({"final_val_metrics": m})
        return out
    return run


def test_cross_validator_fold_parallel_matches_jax(monkeypatch, data_dir,
                                                   tmp_path):
    """With ``cv_train_folds_parallel`` recorded in both packages: the same
    folds, seeds and fold ids, summaries, and resume files; a second run
    resumes every fold."""
    cfg = {"name": "fp/1", "backbone": "resnet_tiny", "img_size": (S, S),
           "seed": 4}
    out = []
    for pkg, kw in ((jax_cv, {}), (cv, {"device": "cpu"})):
        calls = []
        # the JAX harness imports it inside the method, the port's at
        # module level
        monkeypatch.setattr(jax_fp if pkg is jax_cv else cv,
                            "cv_train_folds_parallel", _recorder(calls))
        d = str(tmp_path / pkg.__name__)
        v = pkg.CrossValidator(data_dir, "W", n_splits=3, random_state=2,
                               augmentations_per_image=2, verbose=False,
                               resume_dir=d, fold_parallel=True, **kw)
        first = v.cross_validate_single_model(None, cfg)
        again = v.cross_validate_single_model(None, cfg)
        files = {n: json.load(open(os.path.join(d, n)))
                 for n in sorted(os.listdir(d))}
        strip = lambda r: {**r, "fold_results": [
            {k: x for k, x in f.items() if k != "training_time"}
            for f in r["fold_results"]]}
        assert strip(again) == strip(first)
        out.append((calls, strip(first), {n: {k: x for k, x in f.items()
                                              if k != "training_time"}
                                          for n, f in files.items()}))
    assert out[1] == out[0]
    calls = out[1][0]
    assert len(calls) == 1 and calls[0]["fold_ids"] == [0, 1, 2]
    assert sorted(out[1][2]) == [f"fp_1_fold{k}.json" for k in range(3)]
