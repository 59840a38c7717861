"""The port's fused training run (``segtpu_torch.train.fused_run``) on the
CPU, where its runner calls the same step functions that its CUDA graphs
capture on the card, eagerly, with the same device-side bookkeeping.

- against the JAX package's ``run_training_fused`` on the same weights
  (``state_dict_from_jax``) and shuffle-proof inputs (one image repeated,
  at a batch that leaves a remainder): every decision exactly equal
  (epochs run, LR history, best epoch, whether an epoch improved); the
  losses within ``test_train_model_matches_jax``'s rtol 1e-4 and the
  thresholded metrics within ``tests/test_fused_run.py``'s 2e-4, both
  grown per epoch as that test grows its bar (×(1 + 30·epoch)): Adam
  carries the packages' f32 rounding differences into the next epoch;
  the same run on a mesh of two gloo ranks (``tests/torch_dist_worker.py``,
  ROADMAP A23) by the same bars, its ranks bit for bit equal (the float64
  data-parallel run is in ``tests/test_torch_fused_dp.py``);
- against the port's own stepwise ``train_model``: histories, LR history
  and the final ``state_dict`` equal bit for bit, for every optimizer
  (both loops step the same ``DeviceOptimizer``);
- ``DeviceOptimizer`` against torch's single-tensor optimizers (and, for
  lamb, the per-tensor rule the port ran before the LR moved to the
  device; ``tests/torch_optim_reference.py``) bit for bit, so that the
  stepwise loop keeps its numbers;
- early stopping, best weights, routing, logs, the runner cache and
  ``LRUCache`` against the JAX package's; a float64 state trained in
  float64 (ROADMAP C4).

The card's side (capture, replays, launch counts, the gates' folds) is in
``tests/test_torch_cuda.py``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.core.caching import LRUCache as JaxLRUCache
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu.train.engine import get_engine as jax_get_engine
from segtpu.train.fused_run import run_training_fused as jax_fused
from segtpu_torch.core import tboard
from segtpu_torch.core.caching import LRUCache
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train import fused_run, run_training_fused
from segtpu_torch.train.engine import TrainState, get_engine
from segtpu_torch.train.loop import _materialize, train_model
from segtpu_torch.train.optim import (ReduceLROnPlateau, make_optimizer,
                                      set_learning_rate)
from torch_optim_reference import reference_optimizer, set_reference_lr

S = 32
SCHED = dict(factor=0.5, patience=0, threshold=0.5, min_lr=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runners():
    fused_run.RUNNERS.clear()
    yield
    fused_run.RUNNERS.clear()


def _blobs(r, n, size=S):
    im = r.normal(70, 12, (n, size, size)).clip(0, 255).astype(np.uint8)
    m = np.zeros((n, size, size), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        cy, cx = r.integers(8, size - 8, 2)
        b = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
        im[i][b] = np.clip(im[i][b].astype(int) + 90, 0, 255)
        m[i][b] = 1
    return im, m


@functools.lru_cache(maxsize=None)
def _jax_init(use_attention):
    jm = JaxUNet(backbone="resnet_tiny", use_attention=use_attention)
    return create_model_state(jm, jax.random.key(0), (1, S, S, 1))


def _engine(use_attention=True):
    return get_engine({"backbone": "resnet_tiny",
                       "use_attention": use_attention, "loss_fn": "combo"},
                      device="cpu")


def _port_state(engine, lr=1e-3, wd=1e-5):
    """A state on the JAX model's initial weights, fresh optimizer."""
    att = engine.model_kwargs["use_attention"]
    p, s = _jax_init(att)
    model = engine.build_model()
    model.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", att,
                                              device="cpu"))
    return TrainState(model, engine.make_optimizer(model, lr, wd))


def _seeded_state(engine):
    """A state of the port's own seeded init (no JAX compile)."""
    return engine.init_state(torch.Generator().manual_seed(0), 1e-3, 1e-5)


# ------------------------------------------------ against the JAX package

# 4 training images at batch 4 (one batch, so the order that the packages'
# different generators shuffle it in does not matter) and 2 validation
# images (a remainder); the plateau scheduler cuts unless the IoU rises by
# half; early stopping at ``min_delta`` 0.9 and patience 2 stops the
# 4-epoch run after 3. Without attention: the JAX package's compile of its
# fused program takes most of this file's time, and the gates' path is
# held against the stepwise loop below and on the card.
JAX_RUN = dict(batch_size=4, num_epochs=4, lr0=1e-3, scheduler_params=SCHED,
               es_patience=2, es_min_delta=0.9)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The inputs, the JAX package's fused run on them, and the port's
    data-parallel fused run of them on two gloo ranks
    (``tests/torch_dist_worker.py``), started first and read last."""
    from concurrent.futures import ThreadPoolExecutor
    from torch_dist_worker import launch
    r = np.random.default_rng(0)
    ti, tm = _blobs(r, 4)
    vi, vm = _blobs(r, 2)
    ti_t, tm_t = _materialize(ti, tm, device="cpu")
    vi_t, vm_t = _materialize(vi, vm, device="cpu")
    p, s = _jax_init(False)
    tmp = tmp_path_factory.mktemp("fused_dp_jax")
    torch.save({"state_dict": state_dict_from_jax(p, s, "resnet_tiny", False,
                                                  device="cpu"),
                "ti": ti_t, "tm": tm_t, "vi": vi_t, "vm": vm_t,
                "dtype": torch.float32, "lr": 1e-3, "wd": 1e-5,
                "cfg": {"use_attention": False}, "run": JAX_RUN, "seed": 1},
               tmp / "inputs.pt")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, "fused_dp_jax", 2, tmp, 240)
        nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())
        j_engine = jax_get_engine({"backbone": "resnet_tiny",
                                   "use_attention": False,
                                   "loss_fn": "combo"})
        want = jax_fused(j_engine, j_engine.state_from(p, s, 1e-3, 1e-5),
                         nhwc(ti_t), nhwc(tm_t), nhwc(vi_t), nhwc(vm_t),
                         epoch_keys=jax.random.split(jax.random.key(1), 4),
                         **JAX_RUN)
        return {"inputs": (ti_t, tm_t, vi_t, vm_t), "want": want,
                "ranks": ranks.result()}


def _check_against(got, want):
    """Every decision exactly equal; losses within rtol 1e-4 and the
    thresholded metrics within 2e-4, grown per epoch."""
    assert got["epochs_ran"] == want["epochs_ran"] == 3
    assert got["lr_history"] == pytest.approx(want["lr_history"], rel=1e-6)
    assert got["best_epoch"] == want["best_epoch"]
    assert got["best_found"] == want["best_found"]
    for key in ("train_history", "val_history"):
        for e, (g, w) in enumerate(zip(got[key], want[key])):
            grow = 1 + 30 * e
            np.testing.assert_allclose(g["loss"], w["loss"],
                                       rtol=1e-4 * grow)
            for k in ("iou", "f1", "precision", "recall", "accuracy"):
                np.testing.assert_allclose(g[k], w[k], atol=2e-4 * grow)
    np.testing.assert_allclose(got["best_iou"], want["best_iou"], atol=1e-2)


def test_fused_run_matches_jax(jax_run):
    engine = _engine(use_attention=False)
    got = run_training_fused(engine, _port_state(engine), *jax_run["inputs"],
                             generator=torch.Generator().manual_seed(1),
                             **JAX_RUN)
    _check_against(got, jax_run["want"])


def test_dp_fused_run_matches_jax(jax_run):
    """The same run on a mesh of two gloo ranks (each with 2 of the 4
    training rows and 1 of the 2 validation rows) against the JAX
    package's single-device run and the port's one-process run, by the
    bars above; both ranks end with the same histories and weights, bit
    for bit."""
    r0, r1 = jax_run["ranks"]
    _check_against(r0["dp_run"], jax_run["want"])
    _check_against(r0["dp_run"], r0["one"])
    assert r0["dp"] == r1["dp"]


# ------------------------------------------- against the stepwise loop

def _fit(fused, n_classes=1, optimizer="adam", num_epochs=2, seed=0,
         sched=True, **cfg):
    """train_model on 3 training images and 3 validation images at batch
    2 (a full batch and a remainder of one each), fused or stepwise."""
    r = np.random.default_rng(seed)
    ti, tm = _blobs(r, 3)
    vi, vm = _blobs(r, 3)
    if n_classes > 1:
        tm, vm = (m * r.integers(1, n_classes, m.shape).astype(np.uint8)
                  for m in (tm, vm))
    config = dict(backbone="resnet_tiny", use_attention=True,
                  img_size=(S, S), batch_size=2, verbose=False,
                  loss_fn="combo", seed=0, optimizer=optimizer,
                  n_classes=n_classes, fused_run=fused, **cfg)
    return train_model(None, ti, tm, vi, vm, num_epochs=num_epochs,
                       device="cpu", config=config,
                       scheduler=ReduceLROnPlateau(1e-3, patience=0,
                                                   threshold=0.5)
                       if sched else None)


def _same_dict(a, b):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _same_run(a, b):
    """Histories, decisions, the returned weights (the best epoch's) and
    the best-weights snapshot equal bit for bit."""
    for key in ("train_metrics", "val_metrics", "lr_history", "best_iou",
                "best_epoch"):
        assert a[key] == b[key], key
    _same_dict(a["state"].model.state_dict(), b["state"].model.state_dict())
    assert (a["best_model_state"] is None) == (b["best_model_state"] is None)
    if a["best_model_state"] is not None:
        _same_dict(a["best_model_state"], b["best_model_state"])


@pytest.mark.parametrize("optimizer,n_classes,remat",
                         [("adam", 1, "none"), ("adamw", 1, "full"),
                          ("sgd", 3, "none"), ("lamb", 1, "none")],
                         ids=["adam", "adamw-remat", "sgd-3-classes", "lamb"])
def test_fused_train_model_equals_stepwise_bit_for_bit(optimizer,
                                                       n_classes, remat):
    """``remat="full"`` takes the fused run too, as in the JAX package
    (the forward re-run in backward is part of the captured step)."""
    step = _fit(False, n_classes, optimizer, remat=remat)
    fused = _fit(True, n_classes, optimizer, remat=remat)
    _same_run(fused, step)
    assert len(fused_run.RUNNERS) == 1
    # the optimizer's state is handed back as the stepwise loop leaves it
    so, fo = step["state"].optimizer, fused["state"].optimizer
    assert so.param_groups[0]["lr"] == fo.param_groups[0]["lr"]
    for ps, pf in zip(so.param_groups[0]["params"],
                      fo.param_groups[0]["params"]):
        a, b = so.state[ps], fo.state[pf]
        assert a.keys() == b.keys()
        for k in a:
            assert (torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                    else a[k] == b[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,kw", [("adam", {}), ("adamw", {}),
                                     ("sgd", {}), ("sgd", {"nesterov": True}),
                                     ("lamb", {})],
                         ids=["adam", "adamw", "sgd", "sgd-nesterov", "lamb"])
def test_optimizer_steps_as_the_single_tensor_rule(name, kw, dtype):
    """Six steps with weight decay and an LR that changes between them:
    the parameters equal the reference optimizer's bit for bit (the
    stepwise loop keeps the numbers it had with torch's single-tensor
    optimizers on the CPU; the card's side is in
    ``tests/test_torch_cuda.py``), and the state
    copied into a new optimizer (``like``, ``copy_from``), as the fused run
    hands it back, continues as the original does."""
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen, dtype=dtype)
            for s in ((7, 5), (11,), (3, 2, 3, 3))]
    pa = [t.clone().requires_grad_() for t in init]
    pb = [t.clone().requires_grad_() for t in init]
    ref = reference_optimizer(name, pa, 1e-3, 1e-2, **kw)
    opt = make_optimizer(name, pb, 1e-3, 1e-2, **kw)
    for lr in (1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4, 2.5e-4):
        grads = [torch.randn(t.shape, generator=gen, dtype=dtype)
                 for t in init]
        for ps in (pa, pb):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        set_reference_lr(ref, lr)
        ref.step()
        set_learning_rate(opt, lr)
        opt.step()
        assert all(torch.equal(a, b) for a, b in zip(pa, pb)), lr
    back = opt.like([t.detach().clone() for t in pb])
    back.copy_from(opt)
    assert float(back.lr) == 2.5e-4 and back.rule == name
    for p in (*back.param_groups[0]["params"], *pa):
        p.grad = torch.ones_like(p)
    back.step()
    ref.step()
    assert all(torch.equal(a, b) for a, b in
               zip(pa, back.param_groups[0]["params"]))


def test_optimizer_refuses_a_missing_gradient():
    p = [torch.zeros(3, requires_grad=True), torch.zeros(2,
                                                         requires_grad=True)]
    opt = make_optimizer("adam", p)
    p[0].grad = torch.ones(3)
    with pytest.raises(RuntimeError, match="every parameter"):
        opt.step()


def test_fused_run_trains_a_float64_state_in_float64():
    """ROADMAP C4: the runner builds its model in the state's parameter
    dtype, so a float64 state trains in float64, as it does stepwise: one
    fused epoch equals the engine's float64 epoch from the same state and
    generator, bit for bit (a runner in f32 parts from it by f32's
    rounding)."""
    from segtpu_torch.data.loader import DeviceDataLoader
    engine = _engine(use_attention=False)
    r = np.random.default_rng(4)
    ti, tm = (t.double() for t in _materialize(*_blobs(r, 6), device="cpu"))
    vi, vm = (t.double() for t in _materialize(*_blobs(r, 3), device="cpu"))
    states = []
    for _ in range(2):
        st = _seeded_state(engine)
        st.model.double()
        states.append(TrainState(st.model, engine.make_optimizer(
            st.model, 1e-3, 1e-5)))
    out = run_training_fused(engine, states[0], ti, tm, vi, vm,
                             batch_size=4, num_epochs=1, lr0=1e-3,
                             generator=torch.Generator().manual_seed(1))
    ref, _, _ = engine.run_train_and_eval_epoch_async(
        states[1], DeviceDataLoader(ti, tm, 4),
        DeviceDataLoader(vi, vm, 4, shuffle=False), 1e-3,
        torch.Generator().manual_seed(1))
    got, want = (s.model.state_dict() for s in (out["final_state"], ref))
    assert got["conv_final.weight"].dtype == torch.float64
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_early_stopping_cuts_the_run():
    """num_epochs 30, ``min_delta`` 0.9, patience 1: the first epoch counts
    as better, the second cannot, so the run stops after 2 epochs
    (tests/test_fused_run.py's case)."""
    engine = _engine()
    r = np.random.default_rng(5)
    ti, tm = _materialize(*_blobs(r, 4), device="cpu")
    vi, vm = _materialize(*_blobs(r, 2), device="cpu")
    out = run_training_fused(engine, _seeded_state(engine), ti, tm, vi, vm,
                             batch_size=4, num_epochs=30, lr0=1e-3,
                             generator=torch.Generator().manual_seed(1),
                             es_patience=1, es_min_delta=0.9)
    assert out["epochs_ran"] == 2
    assert len(out["train_history"]) == len(out["lr_history"]) == 2
    assert out["lr_history"] == [1e-3, 1e-3]       # no scheduler


def test_no_best_weights_when_no_epoch_improved():
    """With empty validation masks no epoch's IoU exceeds 0: ``best_found``
    is False, ``best_model_state`` None, and the state handed back the
    final one. (Where an epoch improves, the returned weights and the
    snapshot are the best epoch's: ``_same_run`` above.)"""
    engine = _engine()
    r = np.random.default_rng(6)
    ti, tm = _materialize(*_blobs(r, 4), device="cpu")
    vi, _ = _materialize(*_blobs(r, 2), device="cpu")
    state = _seeded_state(engine)
    out = run_training_fused(engine, state, ti, tm, vi, torch.zeros_like(vi),
                             batch_size=4, num_epochs=2, lr0=1e-3,
                             generator=torch.Generator().manual_seed(1))
    assert not out["best_found"] and out["best_iou"] == 0.0
    assert out["best_model_state"] is None
    assert out["state"] is state and out["final_state"] is state
    assert out["epochs_ran"] == 2


# ----------------------------------------------------------- routing

@pytest.mark.parametrize("cfg", [dict(warmup_epochs=1), dict(ema_decay=0.5),
                                 dict(lr_schedule="cosine"),
                                 dict(min_mode=True)],
                         ids=["warmup", "ema", "cosine", "min-scheduler"])
def test_configs_the_fused_run_does_not_cover_train_stepwise(monkeypatch,
                                                             cfg):
    """As ``segtpu/train/loop.py`` routes them: with any of these,
    ``fused_run=True`` trains stepwise and gives the stepwise result."""
    def refuse(*a, **kw):
        raise AssertionError("the fused run was taken")

    cfg = dict(cfg)
    min_mode = cfg.pop("min_mode", False)
    r = np.random.default_rng(1)
    ti, tm = _blobs(r, 4)
    vi, vm = _blobs(r, 2)
    runs = []
    for fused in (False, True):
        if fused:
            monkeypatch.setattr(fused_run, "run_training_fused", refuse)
        config = dict(backbone="resnet_tiny", use_attention=False,
                      img_size=(S, S), batch_size=4, verbose=False,
                      loss_fn="combo", seed=0, fused_run=fused, **cfg)
        sched = ReduceLROnPlateau(1e-3, mode="min") if min_mode else None
        runs.append(train_model(None, ti, tm, vi, vm, num_epochs=1,
                                device="cpu", config=config,
                                scheduler=sched))
    _same_run(*runs)
    assert len(fused_run.RUNNERS) == 0


# -------------------------------------------------------------- logs

def test_metrics_log_and_tensorboard_equal_the_stepwise_run(tmp_path):
    out = []
    for fused in (False, True):
        root = tmp_path / str(fused)
        res = _fit(fused, metrics_log=str(root / "m.jsonl"),
                   tensorboard_dir=str(root / "tb"))
        recs = [json.loads(line) for line in open(root / "m.jsonl")]
        (ev,) = os.listdir(root / "tb")
        events = list(tboard.read_scalar_events(str(root / "tb" / ev)))
        out.append((res, recs, events))
    (_, r0, e0), (_, r1, e1) = out
    assert len(r0) == len(r1) == 2
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"}
                          for r in recs]
    assert strip(r1) == strip(r0)
    assert [(s, v) for _, s, v in e1] == [(s, v) for _, s, v in e0]
    assert {"lr", "train/loss", "val/iou"} <= set(e1[0][2])


# -------------------------------------------------- caches and runners

def test_lru_cache_matches_jax():
    ops = [("set", "a", 1), ("set", "b", 2), ("get", "a"), ("set", "c", 3),
           ("set", "d", 4), ("get", "b"), ("get", "c"), ("set", "a", 5),
           ("item", "c"), ("set", "e", 6), ("contains", "d")]
    caches = [LRUCache(3), JaxLRUCache(3)]
    for op in ops:
        seen = []
        for c in caches:
            if op[0] == "set":
                c[op[1]] = op[2]
                seen.append(None)
            elif op[0] == "get":
                seen.append(c.get(op[1], "missing"))
            elif op[0] == "item":
                seen.append(c[op[1]])
            else:
                seen.append(op[1] in c)
        assert seen[0] == seen[1], op
        assert list(caches[0]._d.items()) == list(caches[1]._d.items()), op
    assert len(caches[0]) == len(caches[1]) == 3
    assert caches[0].keys() == ["a", "c", "e"]
    for cls in (LRUCache, JaxLRUCache):
        with pytest.raises(ValueError, match="cap"):
            cls(0)


def test_runner_cache_reuses_adds_and_evicts():
    """Equal shapes reuse one runner; a new shape adds one; past the cap
    of 2 the least recently used is dropped."""
    engine = _engine()
    r = np.random.default_rng(3)
    ti, tm = _materialize(*_blobs(r, 4), device="cpu")
    vi, vm = _materialize(*_blobs(r, 2), device="cpu")

    def run(b, n=4):
        run_training_fused(engine, _seeded_state(engine), ti[:n], tm[:n], vi,
                           vm, batch_size=b, num_epochs=1, lr0=1e-3,
                           generator=torch.Generator().manual_seed(1))
        return fused_run.RUNNERS.keys()[-1]

    first = run(4)
    runner = fused_run.RUNNERS[first]
    assert run(4) == first and len(fused_run.RUNNERS) == 1
    assert runner.stats["runs"] == 2
    second = run(2)
    assert second != first and len(fused_run.RUNNERS) == 2
    third = run(2, n=3)
    assert len(fused_run.RUNNERS) == 2
    assert fused_run.RUNNERS.keys() == [second, third]
    assert first not in fused_run.RUNNERS
