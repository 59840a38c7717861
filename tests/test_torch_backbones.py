"""The resnet50 and densenet121 U-Nets of the port against the JAX
package's, at full depth, on the CPU: the eval forward at 32², B=2; the
train mode and one train step at 64², B=2.

Weights: a port model's random initialisation with BatchNorm statistics,
scales and every bias drawn from a seeded numpy generator; its
``state_dict`` goes to the JAX package through its own converter
(``segtpu.models.torch_convert.load_reference_checkpoint``, the reverse
path), and the port model under test takes the JAX variables back through
``state_dict_from_jax``. Both conversions are exact, which a test here
holds bit for bit.

Tolerances, and why:
- eval mode in f32: within 1e-4 of the output's largest magnitude (the
  same f32 operations summed in other orders; measured ≤ 1e-6 of it);
- train mode (batch statistics, the updated running statistics) and one
  train step, in float64: logits within 1e-9 of their largest magnitude,
  each running statistic within 1e-8 of its tensor's largest entry, the
  loss within 1e-6 of itself (the port's metric vector is f32) and every
  gradient within 1e-9 of the largest gradient, which holds the two
  packages to the same mathematics (the bars ``tests/test_torch_train.py``
  holds resnet_tiny to).
  Why float64 and 64²: at 32², B=2 the 1×1 bottom level's BatchNorms
  normalise two values per channel, and the train mode is so
  ill-conditioned that neither precision can hold the packages together.
  There, each package's f32 logits sit 1.5% (resnet50) and 0.3–1.2%
  (densenet121) of their scale from its own float64 logits, and a change
  of 1e-15 of the input moves the port's float64 gradients by 1.6e-6
  (resnet50) and 8.9e-6 (densenet121) of the largest one (measured on
  the CPU with this file's weights and inputs).
  At 64², B=2 (eight values per channel at the bottom) the same change
  moves them by 6.2e-13 and 8.0e-15, so 1e-9 measures the packages, not
  the conditioning. Measured at 64² on float64: up to 4.8e-9 of a
  running mean's scale at the bottom BatchNorm (hence its 1e-8).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.losses import get_loss_function as jax_get_loss
from segtpu.models.torch_convert import load_reference_checkpoint
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.models.backbones import BACKBONE_CHANNELS, make_encoder
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from segtpu_torch.train.engine import TrainState, get_engine

S, B = 32, 2
S_TRAIN = 64
BACKBONES = ("resnet50", "densenet121")
CASES = [(b, a) for b in BACKBONES for a in (True, False)]
IDS = [f"{b}-{'attention' if a else 'no-attention'}" for b, a in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).to(dtype).contiguous(
            memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _port_weights(backbone, use_attention):
    """The port model's ``state_dict``: torch's default initialisation
    (seeded), then BatchNorm statistics, scales and biases from a seeded
    numpy generator."""
    torch.manual_seed(0)
    model = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                             device="cpu")
    r = np.random.default_rng(1 + BACKBONES.index(backbone))
    sd = {}
    for k, v in model.state_dict().items():
        v = v.clone()
        draw = lambda f: torch.from_numpy(f(size=v.shape).astype(np.float32))
        if k.endswith("running_mean") or k.endswith("bias"):
            v = v + 0.05 * draw(r.normal)
        elif k.endswith("running_var"):
            v = draw(lambda size: r.uniform(0.8, 1.2, size))
        elif v.dim() == 1 and k.endswith("weight"):       # BatchNorm scale
            v = draw(lambda size: r.uniform(0.8, 1.2, size))
        sd[k] = v
    return sd


@functools.lru_cache(maxsize=None)
def _jax_variables(backbone, use_attention):
    params, stats = load_reference_checkpoint(
        _port_weights(backbone, use_attention), backbone, use_attention)
    return {"params": params, "batch_stats": stats}


def _port_model(backbone, use_attention):
    v = _jax_variables(backbone, use_attention)
    model = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                             device="cpu")
    model.load_state_dict(state_dict_from_jax(
        v["params"], v["batch_stats"], backbone, use_attention,
        device="cpu"), strict=True)
    return model


def _batch(seed=3, size=S):
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, (B, size, size, 1)).astype(np.float32)
    return x, (x > 0.6).astype(np.float32)


def test_encoders_give_the_reference_features_and_key_names():
    x = torch.zeros(1, 1, 64, 64).contiguous(memory_format=torch.channels_last)
    for backbone in BACKBONES:
        enc = make_encoder(backbone, device="cpu").eval()
        with torch.no_grad():
            feats = enc(x)
        assert [f.shape[1] for f in feats] == list(BACKBONE_CHANNELS[backbone])
        assert [f.shape[-1] for f in feats] == [32, 16, 8, 4, 2]
    keys = set(UNetWithBackbone(backbone="resnet50", device="cpu")
               .state_dict())
    assert {"enc1.0.conv3.weight", "enc1.0.bn3.running_var",
            "enc1.0.downsample.0.weight", "enc4.2.conv3.weight"} <= keys
    assert "enc1.1.downsample.0.weight" not in keys
    keys = set(UNetWithBackbone(backbone="densenet121", device="cpu")
               .state_dict())
    assert {"input_conv.weight", "features.norm0.weight",
            "features.denseblock4.denselayer16.conv2.weight",
            "features.transition3.conv.weight"} <= keys
    assert not any(k.startswith(("features.conv0", "features.norm5",
                                 "features.transition4")) for k in keys)


def _round_trip(backbone, use_attention):
    """port state_dict → segtpu's load_reference_checkpoint →
    state_dict_from_jax gives back every tensor bit for bit."""
    sd = _port_weights(backbone, use_attention)
    v = _jax_variables(backbone, use_attention)
    back = state_dict_from_jax(v["params"], v["batch_stats"], backbone,
                               use_attention, device="cpu")
    assert set(back) == set(sd)
    for k, t in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], t), k


def _to_port_f64(params, stats, backbone, use_attention):
    """Float64 JAX trees as the port's float64 state_dict:
    ``state_dict_from_jax`` converts to float32, so each tree goes across
    as its f32 head plus its f32 remainder (48 significant bits)."""
    def split(t):
        hi = jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        lo = jax.tree.map(lambda a, h: np.asarray(np.asarray(a) - h,
                                                  np.float32), t, hi)
        return hi, lo

    (ph, pl), (sh, sl) = split(params), split(stats)
    hi = state_dict_from_jax(ph, sh, backbone, use_attention, device="cpu")
    lo = state_dict_from_jax(pl, sl, backbone, use_attention, device="cpu")
    return {k: hi[k].double() + lo[k].double() for k in hi}


def _eval_forward(backbone, use_attention):
    x, _ = _batch()
    jm = JaxUNet(backbone=backbone, use_attention=use_attention)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _jax_variables(backbone, use_attention), jnp.asarray(x)))
    model = _port_model(backbone, use_attention).eval()
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    assert got.shape == want.shape == (B, S, S, 1)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def _jax_train_f64(backbone, use_attention, x, y):
    """The JAX model's train-mode forward and one backward in float64:
    (loss, logits, gradients, updated batch_stats), as numpy."""
    v = _jax_variables(backbone, use_attention)
    with jax.enable_x64(True):
        jm = JaxUNet(backbone=backbone, use_attention=use_attention,
                     dtype=jnp.float64)
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                for t in (v["params"], v["batch_stats"]))
        loss_fn = jax_get_loss({"loss_fn": "combo"})

        # the statistics and the batch are arguments, not constants of
        # the traced function: XLA compiles the step faster without them
        def loss_f(params, stats, x, y):
            logits, mut = jm.apply({"params": params, "batch_stats": stats},
                                   x, train=True, mutable=["batch_stats"])
            return loss_fn(logits, y), (logits, mut["batch_stats"])

        (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
            loss_f, has_aux=True))(p, s, jnp.asarray(x, jnp.float64),
                                   jnp.asarray(y, jnp.float64))
        host = lambda t: jax.tree.map(np.asarray, t)
        return float(loss), np.asarray(logits), host(grads), host(stats)


def _check_train_mode(model, logits, want_logits, stats, backbone,
                      use_attention):
    """Train-mode logits and every updated running statistic of the port's
    float64 model against the JAX package's."""
    np.testing.assert_allclose(_nhwc(logits), want_logits,
                               atol=1e-9 * np.abs(want_logits).max())
    params = _jax_variables(backbone, use_attention)["params"]
    want = _to_port_f64(params, stats, backbone, use_attention)
    n = 0
    for k, t in model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(
                t, want[k], rtol=0, atol=1e-8 * float(want[k].abs().max()),
                msg=k)
            n += 1
    assert n > 50


# train mode for every case: the float64 train step for one case of each
# backbone, the float64 forward for the other
STEP_CASES = [("resnet50", True), ("densenet121", False)]
FORWARD_CASES = [c for c in CASES if c not in STEP_CASES]


def cases(backbone, among=CASES):
    """``among``'s cases of ``backbone`` with their ids, for
    ``parametrize``."""
    picked = [c for c in among if c[0] == backbone]
    return dict(argvalues=picked, ids=[IDS[CASES.index(c)] for c in picked])


def _train_mode_forward(backbone, use_attention):
    x, _ = _batch(size=S_TRAIN)
    v = _jax_variables(backbone, use_attention)
    with jax.enable_x64(True):
        jm = JaxUNet(backbone=backbone, use_attention=use_attention,
                     dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        want, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))
        want = np.asarray(want)
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
    model = _port_model(backbone, use_attention).double().train()
    with torch.no_grad():
        got = model(_nchw(x, torch.float64))
    _check_train_mode(model, got, want, stats, backbone, use_attention)


def _train_step(backbone, use_attention):
    """One float64 train step (combo loss): the loss, every gradient, the
    train-mode logits and the updated running statistics."""
    x, y = _batch(seed=4, size=S_TRAIN)
    jl, jlogits, jg, jstats = _jax_train_f64(backbone, use_attention, x, y)
    eng = get_engine({"backbone": backbone, "use_attention": use_attention,
                      "loss_fn": "combo"}, device="cpu")
    model = _port_model(backbone, use_attention).double()
    with torch.no_grad():
        logits = copy.deepcopy(model).train()(_nchw(x, torch.float64))
    st = TrainState(model, eng.make_optimizer(model, 1e-3, 1e-5))
    _, m = eng.train_step(st, _nchw(x, torch.float64),
                          _nchw(y, torch.float64))
    assert abs(float(m["loss"]) - jl) <= 1e-6 * abs(jl)
    want = _to_port_f64(jg, jstats, backbone, use_attention)
    grads = {k: p.grad for k, p in model.named_parameters()}
    gmax = max(float(want[k].abs().max()) for k in grads)
    assert gmax > 0
    for k, g in grads.items():
        torch.testing.assert_close(g, want[k], rtol=0, atol=1e-9 * gmax,
                                   msg=k)
    _check_train_mode(model, logits, jlogits, jstats, backbone,
                      use_attention)


# resnet50's cases here, densenet121's in tests/test_torch_backbones_densenet.py
# (one file a backbone, so that their compiles run on two test workers)
@pytest.mark.parametrize("backbone,use_attention", **cases("resnet50"))
def test_state_dict_round_trips_through_both_converters(backbone,
                                                        use_attention):
    _round_trip(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention", **cases("resnet50"))
def test_unet_eval_forward_matches_jax_in_f32(backbone, use_attention):
    _eval_forward(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention",
                         **cases("resnet50", FORWARD_CASES))
def test_unet_train_mode_forward_matches_jax_in_float64(backbone,
                                                        use_attention):
    _train_mode_forward(backbone, use_attention)


@pytest.mark.parametrize("backbone,use_attention",
                         **cases("resnet50", STEP_CASES))
def test_train_step_matches_jax_in_float64(backbone, use_attention):
    _train_step(backbone, use_attention)
