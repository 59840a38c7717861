"""The port's training path (segtpu_torch.train) against the JAX
package's (segtpu.train), on the same seeded numpy inputs and the same
weights (moved across by ``state_dict_from_jax``), on the CPU.

Tolerances, and why:
- optimizers over 3 steps: atol 1e-6 (the same update rules; f32
  rounding of a few dozen operations on O(1) values);
- one train step in float64 (both packages, ``jax.enable_x64``): logits,
  gradients and BatchNorm statistics within 1e-9 of their scale
  (measured: 5e-10 of the largest gradient), which holds the two to the
  same mathematics; updated parameters within that gradient bar times
  Adam's largest slope lr/eps;
- one train step in float32, the path the card runs: loss rtol 1e-5,
  logits atol 2e-4 (tests/test_torch_models.py's bar), running variance
  rtol 1e-5 (measured ≤ 2.3e-6) and running mean within 1e-4 of its
  tensor's largest entry. Gradients and updated parameters are held in
  float64 above: flax's BatchNorm computes the variance as E[x²] − E[x]²
  (``use_fast_variance``), and in f32 that cancellation moves some of the
  JAX package's own gradients by a large share of their tensor's largest
  entry against its float64 gradients, while the port's f32 gradients
  stay within 5e-4 of them;
- ``train_model`` over 2 epochs (f32, Adam): epoch losses rtol 1e-4
  (measured 2e-5), IoUs atol 1e-2 (a pixel that crosses 0.5 moves the
  IoU of a 32² validation pair by ~0.003), LR history and best epoch
  exact; the same bars for one epoch whose last batch holds one image.
- BatchNorm statistics after one float64 step: within 1e-9 of their
  tensor's largest entry.
"""

import copy
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.losses import get_loss_function as jax_get_loss
from segtpu.losses.multiclass import get_multiclass_loss as jax_get_mc_loss
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu.train.engine import TrainState as JaxTrainState
from segtpu.train.loop import train_model as jax_train_model
from segtpu.train.optim import EarlyStopping as JaxEarlyStopping
from segtpu.train.optim import ReduceLROnPlateau as JaxPlateau
from segtpu.train.optim import make_optimizer as jax_make_optimizer
from segtpu_torch.data.loader import DeviceDataLoader
from segtpu_torch.models import attention as attention_module
from segtpu_torch.models import unet as unet_module
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train.engine import METRIC_KEYS, TrainState, get_engine
from segtpu_torch.train.loop import evaluate, train_epoch, train_model
from segtpu_torch.train.optim import (EarlyStopping, ReduceLROnPlateau,
                                      make_optimizer)
from torch_jax_init import drawn_variables

S, B, LR, WD = 32, 2, 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host's cores: one intra-op thread
    per process keeps torch's thread pool from oversubscribing them (with
    a pool per process, these tests ran 100× slower beside the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).to(dtype).contiguous(
            memory_format=torch.channels_last)


def _batch(seed=1):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, (B, S, S, 1)).astype(np.float32)
    return x, (x > 0.6).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(use_attention, n_classes=1):
    """The JAX model and its own initial variables (``train_model``'s
    runs below, whose decisions depend on the weights they start from)."""
    jm = JaxUNet(backbone="resnet_tiny", use_attention=use_attention,
                 n_classes=n_classes)
    return jm, create_model_state(jm, jax.random.key(0), (1, S, S, 1))


@functools.lru_cache(maxsize=None)
def _step_init(use_attention, n_classes=1):
    """The JAX model and variables at flax's initial distributions, drawn
    without compiling its init (``tests/torch_jax_init.py``): the single
    steps only need both packages on the same weights."""
    jm = JaxUNet(backbone="resnet_tiny", use_attention=use_attention,
                 n_classes=n_classes)
    return jm, drawn_variables(jm, 0, (1, S, S, 1))


def _engine(use_attention, **cfg):
    return get_engine({"backbone": "resnet_tiny",
                       "use_attention": use_attention, "loss_fn": "combo",
                       **cfg}, device="cpu")


def _port_state(use_attention, dtype=torch.float32, init=None, **cfg):
    """An engine and a state on ``init``'s weights (``_step_init``'s by
    default)."""
    eng = _engine(use_attention, **cfg)
    _, (p, s) = (init or _step_init)(use_attention, cfg.get("n_classes", 1))
    model = eng.build_model()
    model.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny",
                                              use_attention, device="cpu"))
    model.to(dtype)
    return eng, TrainState(model, eng.make_optimizer(model, LR, WD))


def _to_port_f64(tree, stats, use_attention):
    """Float64 JAX params and batch_stats trees as the port's state_dict
    in float64: ``state_dict_from_jax`` converts to float32, so each tree
    goes across as its f32 head plus its f32 remainder (48 significant
    bits)."""
    def split(t):
        hi = jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        lo = jax.tree.map(lambda a, h: np.asarray(np.asarray(a) - h,
                                                  np.float32), t, hi)
        return hi, lo

    (ph, pl), (sh, sl) = split(tree), split(stats)
    hi = state_dict_from_jax(ph, sh, "resnet_tiny", use_attention,
                             device="cpu")
    lo = state_dict_from_jax(pl, sl, "resnet_tiny", use_attention,
                             device="cpu")
    return {k: hi[k].double() + lo[k].double() for k in hi}


# ----------------------------------------------------------- optimizers

OPTIMIZERS = [("adam", {}), ("adamw", {}), ("sgd", {}),
              ("sgd", {"nesterov": True}), ("lamb", {})]


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("rmsprop", [torch.zeros(1, requires_grad=True)])


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_and_early_stopping_match_jax(mode):
    series = [0.1, 0.2, 0.2, 0.19, 0.21, 0.21, 0.2, 0.2, 0.25, 0.25,
              0.25, 0.25, 0.25, 0.1, -0.3, -0.31, -0.31, -0.31]
    ours = ReduceLROnPlateau(1e-3, mode=mode, patience=2, threshold=0.01,
                             min_lr=2e-4)
    ref = JaxPlateau(1e-3, mode=mode, patience=2, threshold=0.01,
                     min_lr=2e-4)
    es, es_ref = EarlyStopping(patience=3), JaxEarlyStopping(patience=3)
    for v in series:
        assert ours.safe_horizon() == ref.safe_horizon()
        assert es.safe_horizon() == es_ref.safe_horizon()
        assert ours.step(v) == ref.step(v)
        assert es.step(v) == es_ref.step(v)
        assert (ours.best, ours.num_bad_epochs) == (ref.best,
                                                    ref.num_bad_epochs)
        assert (es.best_score, es.counter) == (es_ref.best_score,
                                               es_ref.counter)


# ------------------------------------------------------ one train step

def _jax_step(use_attention, x, y, dtype, n_classes=1, init=None):
    """JAX's train step, written out: (loss, logits, grads, new
    batch_stats, new params) as numpy trees in ``dtype``, from ``init``'s
    weights (``_step_init``'s by default)."""
    jm0, (p, s) = (init or _step_init)(use_attention, n_classes)
    jm = JaxUNet(backbone="resnet_tiny", use_attention=use_attention,
                 n_classes=n_classes, dtype=dtype)
    p, s = (jax.tree.map(lambda a: jnp.asarray(a, dtype), t) for t in (p, s))
    loss_fn = (jax_get_mc_loss if n_classes > 1 else jax_get_loss)(
        {"loss_fn": "combo"})

    # the statistics and the batch are arguments, not constants of the
    # traced function: XLA compiles the step 3× faster without them
    def loss_f(params, stats, x, y):
        logits, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        return loss_fn(logits, y), (logits, mut["batch_stats"])

    (loss, (logits, bs)), grads = jax.jit(jax.value_and_grad(
        loss_f, has_aux=True))(p, s, jnp.asarray(x, dtype),
                               jnp.asarray(y, dtype))
    tx = jax_make_optimizer("adam", LR, WD)
    upd, _ = tx.update(grads, tx.init(p), p)
    new_p = optax.apply_updates(p, upd)
    host = lambda t: jax.tree.map(np.asarray, t)
    return (float(loss), np.asarray(logits), host(grads), host(bs),
            host(new_p))


def _port_step(use_attention, x, y, dtype, **cfg):
    eng, st = _port_state(use_attention, dtype, **cfg)
    xt, yt = _nchw(x, dtype), _nchw(y, dtype)
    with torch.no_grad():
        logits = copy.deepcopy(st.model).train()(xt)
    st, m = eng.train_step(st, xt, yt)
    grads = {k: p.grad for k, p in st.model.named_parameters()}
    return float(m["loss"]), logits.permute(0, 2, 3, 1).numpy(), grads, \
        st.model.state_dict()


def _check_step_in_float64(use_attention, x, y, n_classes=1):
    """One float64 train step of both packages on (x, y): loss, logits,
    gradients, updated parameters and BatchNorm statistics. Returns the
    port's state_dict after the step."""
    with jax.enable_x64(True):
        jl, jlg, jg, jbs, jp = _jax_step(use_attention, x, y, jnp.float64,
                                         n_classes)
    tl, tlg, tg, tsd = _port_step(use_attention, x, y, torch.float64,
                                  n_classes=n_classes)
    assert abs(tl - jl) <= 1e-6 * abs(jl)    # the metric vector is f32
    np.testing.assert_allclose(tlg, jlg, atol=1e-9 * np.abs(jlg).max())

    want_g = _to_port_f64(jg, jbs, use_attention)
    gmax = max(float(want_g[k].abs().max()) for k in tg)
    for k, g in tg.items():
        torch.testing.assert_close(g, want_g[k], rtol=0, atol=1e-9 * gmax)
    want = _to_port_f64(jp, jbs, use_attention)
    for k, v in tsd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
            continue
        if "running" in k:
            torch.testing.assert_close(
                v, want[k], rtol=0, atol=1e-9 * float(want[k].abs().max()))
            continue
        # Adam's first move is lr·g/(|g| + eps), whose slope at g ≈ 0 is
        # lr/eps: a gradient within 1e-9·gmax moves within that times it
        torch.testing.assert_close(v, want[k], rtol=1e-9,
                                   atol=LR / 1e-8 * 1e-9 * gmax)
    return tsd


def _bottom_level_vars(sd):
    return {k: v for k, v in sd.items()
            if k.startswith("enc4.") and k.endswith("running_var")}


# --------------------------------------------------- accum and remat

# ------------------------------------------------------- train_model

def _blobs(r, n):
    im = r.normal(70, 12, (n, S, S)).clip(0, 255).astype(np.uint8)
    m = np.zeros((n, S, S), np.uint8)
    yy, xx = np.mgrid[:S, :S]
    for i in range(n):
        cy, cx = r.integers(8, 24, 2)
        b = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
        im[i][b] = np.clip(im[i][b].astype(int) + 90, 0, 255)
        m[i][b] = 1
    return im, m


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_train_model_matches_jax(use_attention):
    """Two epochs of 4 training images at batch 4 (one batch, so the
    shuffle order does not matter) and 2 validation images; the plateau
    scheduler halves the LR after epoch 2."""
    r = np.random.default_rng(0)
    ti, tm = _blobs(r, 4)
    vi, vm = _blobs(r, 2)
    cfg = dict(backbone="resnet_tiny", use_attention=use_attention,
               img_size=(S, S), batch_size=4, verbose=False,
               loss_fn="combo", seed=0)
    _, (p, s) = _jax_init(use_attention)
    want = jax_train_model(
        None, ti, tm, vi, vm, num_epochs=2, config=cfg,
        scheduler=JaxPlateau(1e-3, patience=0, threshold=0.5),
        initial_state=JaxTrainState(p, s, None))
    eng = _engine(use_attention)
    model = eng.build_model()
    model.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny",
                                              use_attention, device="cpu"))
    got = train_model(None, ti, tm, vi, vm, num_epochs=2, device="cpu",
                      config=cfg,
                      scheduler=ReduceLROnPlateau(1e-3, patience=0,
                                                  threshold=0.5),
                      initial_state=TrainState(model))
    assert set(got) == set(want)
    assert got["lr_history"] == want["lr_history"] == [1e-3, 5e-4]
    assert got["best_epoch"] == want["best_epoch"]
    for key in ("train_metrics", "val_metrics"):
        assert len(got[key]) == len(want[key]) == 2
        for g, w in zip(got[key], want[key]):
            assert set(g) == set(w) == set(METRIC_KEYS)
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            for k in ("iou", "f1", "precision", "recall", "accuracy"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-2)
    np.testing.assert_allclose(got["best_iou"], want["best_iou"], atol=1e-2)
    assert got["final_val_metrics"] == got["val_metrics"][-1]
    assert isinstance(got["best_model_state"], dict)
    assert got["state"].model is model


def test_train_model_from_scratch_is_seeded_and_learns():
    """Without an initial state the weights come from config['seed'] (a
    CPU generator): two runs agree exactly; the bce prior is applied."""
    r = np.random.default_rng(3)
    ti, tm = _blobs(r, 4)
    vi, vm = _blobs(r, 2)
    cfg = dict(backbone="resnet_tiny", use_attention=False, img_size=(S, S),
               batch_size=4, verbose=False, loss_fn="bce", seed=5,
               ema_decay=0.5, warmup_epochs=1, lr_schedule="cosine")
    runs = [train_model(None, ti, tm, vi, vm, num_epochs=3, device="cpu",
                        config=cfg) for _ in range(2)]
    assert runs[0]["train_metrics"] == runs[1]["train_metrics"]
    assert runs[0]["lr_history"][0] == pytest.approx(1e-3)
    assert runs[0]["train_metrics"][-1]["loss"] < \
        runs[0]["train_metrics"][0]["loss"]
    assert set(runs[0]["ema_val_metrics"]) == set(METRIC_KEYS)
    fg = float((tm > 0).mean())
    bias = runs[0]["ema_state"].model.conv_final.bias.detach()
    assert abs(float(bias) - np.log(fg / (1 - fg))) < 0.1


def test_train_model_with_a_remainder_of_one_matches_jax():
    """ROADMAP C1 through ``train_model``: 5 training images at batch 2,
    so the epoch's last step trains on one image, whose 1×1 bottom level
    gives each BatchNorm there one value per channel. The five are one
    image five times, so that the shuffle order, which the two packages
    draw from different generators, does not change what either trains
    on."""
    r = np.random.default_rng(8)
    one_i, one_m = _blobs(r, 1)
    ti, tm = np.repeat(one_i, 5, 0), np.repeat(one_m, 5, 0)
    vi, vm = _blobs(r, 2)
    cfg = dict(backbone="resnet_tiny", use_attention=True, img_size=(S, S),
               batch_size=2, verbose=False, loss_fn="combo", seed=0)
    _, (p, s) = _jax_init(True)
    want = jax_train_model(None, ti, tm, vi, vm, num_epochs=1, config=cfg,
                           initial_state=JaxTrainState(p, s, None))
    model = _engine(True).build_model()
    model.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", True,
                                              device="cpu"))
    got = train_model(None, ti, tm, vi, vm, num_epochs=1, device="cpu",
                      config=cfg, initial_state=TrainState(model))
    for key in ("train_metrics", "val_metrics"):
        g, w = got[key][0], want[key][0]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        for k in ("iou", "f1", "precision", "recall", "accuracy"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-2)


# ------------------------------------------- kernel callers in training

def _gate_spy(monkeypatch):
    """Record the dtypes each attention-gate and upsample wrapper call
    receives, then run the wrapper."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, tuple(a.dtype for a in args)))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(attention_module, "attention_gate",
                        spy("gate", attention_module.attention_gate))
    monkeypatch.setattr(unet_module, "upsample2x_concat",
                        spy("upsample", unet_module.upsample2x_concat))
    return calls


def test_bf16_engine_keeps_f32_params_and_trains():
    r = np.random.default_rng(6)
    ti, tm = _blobs(r, 4)
    eng = _engine(True, dtype="bfloat16")
    st = eng.init_state(torch.Generator().manual_seed(0), LR, WD)
    imgs = _nchw(np.asarray(ti, np.float32)[..., None] / 255.0)
    masks = _nchw(np.asarray(tm, np.float32)[..., None])
    loader = DeviceDataLoader(imgs, masks, batch_size=2, shuffle=False)
    st, m0 = train_epoch(eng, st, loader, LR)
    for _ in range(3):
        st, m = train_epoch(eng, st, loader, LR)
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert all(np.isfinite(v) for v in m.values())
    assert m["loss"] < m0["loss"]
    val = evaluate(eng, st, loader)
    assert set(val) == set(METRIC_KEYS)


# ------------------------------------------------------ engine, device

def test_get_engine_reads_the_jax_keys():
    """A new engine per call, built from the JAX package's config keys:
    the model keys with the port's kernel defaults, the loss keys, the
    optimizer and its keys; ``criterion`` replaces the configured loss."""
    a = _engine(True)
    assert _engine(True) is not a
    assert a.model_kwargs == dict(backbone="resnet_tiny", use_attention=True,
                                  n_classes=1, final_bias_prior=None,
                                  fuse="kernel", fuse_gate=True,
                                  reparam_in_train=False)
    assert _engine(True, reparam_in_train=True).model_kwargs[
        "reparam_in_train"] is True
    assert (a.optimizer_name, a.optimizer_kwargs) == ("adam", {})
    sgd = _engine(False, optimizer="SGD", momentum=0.8, nesterov=True,
                  adam_eps=1e-7, dtype="bfloat16", remat="full")
    assert (sgd.optimizer_name, sgd.optimizer_kwargs) == (
        "sgd", {"momentum": 0.8, "nesterov": True, "eps": 1e-7})
    assert sgd.compute_dtype == torch.bfloat16 and sgd.remat == "full"
    lg = torch.linspace(-3, 3, 2 * S * S).reshape(2, 1, S, S)
    t = (lg > 0.5).float()
    dice = _engine(True, loss_fn="dice").loss_fn(lg, t)
    assert float(dice) != float(a.loss_fn(lg, t))
    own = get_engine({"backbone": "resnet_tiny", "loss_fn": "combo"},
                     lambda lg, t: lg.mean(), device="cpu")
    assert float(own.loss_fn(lg, t)) == float(lg.mean())
    with pytest.raises(ValueError, match="dtype"):
        _engine(True, dtype="float16")


def test_loader_batches_and_remainder():
    imgs = torch.arange(5.0).reshape(5, 1, 1, 1)
    loader = DeviceDataLoader.from_arrays(imgs, imgs, batch_size=2,
                                          shuffle=True, device="cpu")
    assert loader.n == 5 and len(loader) == 3
    (fi, fm), rem = loader.batches(torch.Generator().manual_seed(0))
    assert fi.shape == (2, 2, 1, 1, 1) and rem[0].shape == (1, 1, 1, 1)
    seen = torch.cat([fi.reshape(-1), rem[0].reshape(-1)])
    assert sorted(seen.tolist()) == [0.0, 1.0, 2.0, 3.0, 4.0]
    torch.testing.assert_close(fi, fm)
    assert [b[0].shape[0] for b in loader] == [2, 2, 1]


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = {"backbone": "resnet_tiny"}
    for call in (lambda: get_engine(cfg),
                 lambda: train_model(None, np.zeros((1, S, S), np.uint8),
                                     np.zeros((1, S, S), np.uint8),
                                     config=cfg),
                 lambda: DeviceDataLoader.from_arrays(np.zeros((1, 1, 2, 2)),
                                                      np.zeros((1, 1, 2, 2)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
