"""The port's ``vmap`` fold-parallel strategy (segtpu_torch.train.engine's
``StackedFolds`` and ``run_fold_epochs``, the functional optimizers of
segtpu_torch.train.optim) on the CPU, against the port's own ``stream``
strategy and ``torch.optim``:

- ``vmap`` equals ``stream`` in float64 to 1e-9 of the weights' scale,
  Adam's moments and each fold's BatchNorm statistics included (Adam's
  first steps are sign-like, so only float64 holds two orders of
  summation together);
- the functional optimizers against ``make_optimizer``'s, two folds at
  their own learning rates, float64, to 1e-12;
- every registry loss (and the multiclass ones) under ``vmap``, forward
  and gradient, against each fold alone;
- unequal fold sizes and early stopping per fold, in both strategies;
- the written-out train-mode BatchNorm (taken under ``torch.func``)
  against torch's fused one.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.func import grad, vmap

from segtpu_torch.eval import fold_parallel as fp
from segtpu_torch.eval.folds import kfold_split
from segtpu_torch.losses import get_loss_function, multiclass
from segtpu_torch.losses.multiclass import get_multiclass_loss
from segtpu_torch.losses.registry import available_losses
from segtpu_torch.train.engine import METRIC_KEYS, TrainEngine, get_engine
from segtpu_torch.train.loop import _materialize
from segtpu_torch.train.optim import (functional_init, functional_step,
                                      make_optimizer)

S = 32
CFG = {"backbone": "resnet_tiny", "use_attention": True, "batch_size": 3,
       "img_size": (S, S), "learning_rate": 1e-3, "weight_decay": 1e-5,
       "loss_fn": "bce", "verbose": False, "save_plots": False, "seed": 0}
FOLDS = [(list(range(0, 8)), list(range(8, 12))),
         (list(range(4, 12)), list(range(0, 4)))]


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


class F64Engine(TrainEngine):
    """The port's engine with float64 models (no gate kernel: it takes
    f32 and bf16 only)."""

    def build_model(self):
        return super().build_model().double()


@pytest.fixture(scope="module")
def f64_runs():
    """Two folds on different data, float64, 64², 2 epochs of 3 images at
    B=2 (a remainder of one each epoch): stream and vmap."""
    cfg = dict(CFG, batch_size=2, img_size=(64, 64), num_epochs=2,
               fuse_gate=False, loss_fn="combo")
    base = get_engine(cfg, device="cpu")
    eng = F64Engine(base.model_kwargs, base.loss_fn, device="cpu")
    ci, cm = _blobs(64, 10)
    arrays = [tuple(t.double() for t in _materialize(
        ci[a:a + 3], cm[a:a + 3], device="cpu") + _materialize(
            ci[a + 3:a + 5], cm[a + 3:a + 5], device="cpu"))
        for a in (0, 5)]
    return [fp.train_folds_parallel(arrays, cfg, engine=eng, strategy=s,
                                    device="cpu")
            for s in ("stream", "vmap")]


def _rel_err(a, b):
    keys = [k for k, t in a.items() if t.is_floating_point()]
    scale = max(float(a[k].abs().max()) for k in keys)
    return max(float((a[k] - b[k]).abs().max()) for k in keys) / scale


def test_vmap_equals_stream_in_float64(f64_runs):
    stream, vm = f64_runs
    for s, v in zip(stream, vm):
        assert v["lr_history"] == s["lr_history"]
        assert v["best_epoch"] == s["best_epoch"]
        for key in ("train_metrics", "val_metrics"):
            for sm, vmm in zip(s[key], v[key]):
                assert vmm == pytest.approx(sm, rel=1e-6, abs=1e-9)
        assert _rel_err(s["state"].model.state_dict(),
                        v["state"].model.state_dict()) < 1e-9
        assert _rel_err(s["best_model_state"], v["best_model_state"]) < 1e-9
        so, vo = (r["state"].optimizer.state_dict()["state"]
                  for r in (s, v))
        assert so.keys() == vo.keys()
        for i in so:
            assert float(so[i]["step"]) == float(vo[i]["step"])
            for m in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(vo[i][m], so[i][m], rtol=1e-9,
                                           atol=1e-15)


def test_vmap_keeps_batchnorm_statistics_per_fold(f64_runs):
    stream, vm = f64_runs
    keys = [k for k in vm[0]["state"].model.state_dict()
            if k.endswith(("running_mean", "running_var"))]
    sd = [r["state"].model.state_dict() for r in vm]
    assert all(not torch.equal(sd[0][k], sd[1][k]) for k in keys)
    for s, v in zip(stream, vm):
        ss, vs = (r["state"].model.state_dict() for r in (s, v))
        assert _rel_err({k: ss[k] for k in keys},
                        {k: vs[k] for k in keys}) < 1e-9
        assert int(vs["bn1.num_batches_tracked"]) == int(
            ss["bn1.num_batches_tracked"]) == 4


OPTIMIZERS = [("adam", {}), ("adamw", {}), ("sgd", {}),
              ("sgd", {"nesterov": True}), ("lamb", {})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["adam", "adamw", "sgd", "sgd-nesterov", "lamb"])
def test_functional_step_matches_the_optimizer(name, kw):
    """Two folds at their own learning rates, three steps, float64: each
    fold's parameters and moments against a ``make_optimizer`` of its own
    on the same gradients."""
    r = np.random.default_rng(3)
    shapes = {"w": (4, 3, 3, 3), "psi": (1, 5, 1, 1), "b": (4,)}
    lrs = torch.tensor([1e-3, 3e-4], dtype=torch.float64)
    wd = 1e-2
    p0 = {n: torch.from_numpy(r.normal(size=(2, *s))) for n, s in
          shapes.items()}
    stacked = {n: t.clone() for n, t in p0.items()}
    state = functional_init(name, stacked)
    refs = []
    for k in range(2):
        ps = {n: nn.Parameter(t[k].clone()) for n, t in p0.items()}
        refs.append((ps, make_optimizer(name, list(ps.values()),
                                        float(lrs[k]), wd, **kw)))
    for step in range(1, 4):
        grads = {n: torch.from_numpy(r.normal(size=(2, *s)))
                 for n, s in shapes.items()}
        functional_step(name, stacked, grads, state, lrs, wd, step, **kw)
        for k, (ps, opt) in enumerate(refs):
            for n, p in ps.items():
                p.grad = grads[n][k].clone()
            opt.step()
            for n, p in ps.items():
                torch.testing.assert_close(stacked[n][k], p.detach(),
                                           rtol=1e-12, atol=1e-15)
                ost = opt.state[p]
                for key, t in state.items():
                    torch.testing.assert_close(t[n][k], ost[key],
                                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", available_losses() + [
    "multiclass-" + n for n in ("ce", "dice", "combo", "focal")])
def test_every_loss_runs_under_vmap(name):
    """Forward and gradient of each loss under ``vmap`` over two folds
    equal the loss of each fold alone (the vmap strategy takes any loss
    the sequential path takes)."""
    r = np.random.default_rng(5)
    if name.startswith("multiclass-"):
        fn = get_multiclass_loss({"loss_fn": name.split("-")[1]})
        lg = torch.from_numpy(r.normal(size=(2, 2, 3, 16, 16)))
        y = torch.from_numpy(r.integers(0, 3, (2, 2, 1, 16, 16)).astype(
            np.float64))
    else:
        fn = get_loss_function({"loss_fn": name})
        lg = torch.from_numpy(r.normal(size=(2, 2, 1, 16, 16)))
        y = torch.from_numpy((r.random((2, 2, 1, 16, 16)) > 0.6).astype(
            np.float64))
    torch.testing.assert_close(
        vmap(fn)(lg, y), torch.stack([fn(lg[k], y[k]) for k in range(2)]),
        rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(
        vmap(grad(fn))(lg, y),
        torch.stack([grad(fn)(lg[k], y[k]) for k in range(2)]),
        rtol=1e-12, atol=1e-14)


def test_one_hot_without_sync_matches_f_one_hot():
    """The multiclass losses' one-hot, rewritten by comparison so that it
    runs under vmap, against its old form, ``F.one_hot``."""
    t = torch.from_numpy(np.random.default_rng(2).integers(0, 4, (3, 5, 7)))
    old = torch.nn.functional.one_hot(t, 4).permute(0, 3, 1, 2)
    assert torch.equal(multiclass._one_hot(t, 4, torch.float32),
                       old.float())


@pytest.mark.parametrize("strategy", ["stream", "vmap"])
def test_unequal_fold_sizes(canonical, strategy):
    """kfold_split(10, 3) gives folds of (7, 3) and (6, 4): stream takes
    them in one run, vmap groups them by size; results in fold order."""
    ci, cm = canonical
    folds = list(kfold_split(10, 3, shuffle=True, random_state=1))
    assert len({(len(tr), len(va)) for tr, va in folds}) == 2
    fp.reset_fetch_count()
    res = fp.cv_train_folds_parallel(
        ci[:10], cm[:10], folds,
        dict(CFG, num_epochs=1, use_attention=False,
             fold_parallel_strategy=strategy), device="cpu")
    assert fp.fetch_count() == (1 if strategy == "stream" else 2)
    assert len(res) == 3
    for r in res:
        assert set(r["final_val_metrics"]) == set(METRIC_KEYS)
        assert len(r["val_metrics"]) == 1
        assert r["best_iou"] == pytest.approx(
            max(m["iou"] for m in r["val_metrics"]))
    with pytest.raises(ValueError, match="equal sizes"):
        fp.train_folds_parallel(
            [tuple(_materialize(ci[:n], cm[:n], device="cpu") * 2)
             for n in (3, 4)], CFG, strategy="vmap", device="cpu")


@pytest.mark.parametrize("strategy", ["stream", "vmap"])
def test_early_stop_per_fold(canonical, strategy):
    """An impossible bar stops each fold at its second epoch; under vmap
    the stack stops when every fold has."""
    ci, cm = canonical
    cfg = dict(CFG, num_epochs=4, early_stopping_patience=1,
               early_stopping_min_delta=0.5, use_attention=False,
               fold_parallel_strategy=strategy)
    res = fp.cv_train_folds_parallel(ci, cm, FOLDS, cfg, device="cpu")
    for r in res:
        assert len(r["val_metrics"]) == 2
        assert r["final_val_metrics"] == r["val_metrics"][-1]


@pytest.mark.parametrize("channels", [1, 5])
def test_written_out_batchnorm_matches_the_fused_one(channels, monkeypatch):
    """The train-mode BatchNorm written out in tensor ops (what a forward
    under ``torch.func`` runs) against the port's usual one (torch's fused
    batch norm): output and running statistics in float64 to 1e-12, twice
    in a row; a bf16 input comes back bf16. Under ``vmap`` of
    ``functional_call`` over two folds' stacked state the forward takes
    the written-out formula, each fold's output and statistics its own; a
    plain forward does not take it."""
    from torch.func import functional_call, stack_module_state
    from segtpu_torch.models.backbones import BatchNorm2d
    r = np.random.default_rng(8)
    fused = BatchNorm2d(channels).double().train()
    with torch.no_grad():
        fused.weight.copy_(torch.from_numpy(r.normal(size=channels)))
        fused.bias.copy_(torch.from_numpy(r.normal(size=channels)))
    written = copy.deepcopy(fused)
    for _ in range(2):
        x = torch.from_numpy(r.normal(2.0, 3.0, (3, channels, 4, 5)))
        torch.testing.assert_close(written._forward_written_out(x),
                                   fused(x), rtol=1e-12, atol=1e-12)
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(written, name),
                                       getattr(fused, name), rtol=1e-12,
                                       atol=1e-15)
    assert int(written.num_batches_tracked) == 2
    assert written.float()._forward_written_out(
        x.float().bfloat16()).dtype == torch.bfloat16

    taken, real = [], BatchNorm2d._forward_written_out

    def spy(self, x):
        taken.append(x.shape)
        return real(self, x)

    monkeypatch.setattr(BatchNorm2d, "_forward_written_out", spy)
    folds = [copy.deepcopy(fused), copy.deepcopy(fused)]
    with torch.no_grad():
        folds[1].weight.mul_(2.0)
    params, buffers = stack_module_state(folds)
    xs = torch.from_numpy(r.normal(1.0, 2.0, (2, 3, channels, 4, 5)))
    out = vmap(lambda p, b, x: functional_call(fused, {**p, **b}, (x,)))(
        params, buffers, xs)
    assert taken
    for f, model in enumerate(folds):
        torch.testing.assert_close(out[f], model(xs[f]), rtol=1e-12,
                                   atol=1e-12)
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(buffers[name][f],
                                       getattr(model, name), rtol=1e-12,
                                       atol=1e-15)
    taken.clear()
    fused(xs[0])
    assert not taken
