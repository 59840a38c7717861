"""Port modules (segtpu_torch.models) vs the JAX package's modules, on the
same numpy inputs and the same weights (moved across by
``state_dict_from_jax``), in float32 on the CPU.

Tolerance: atol 2e-4 on logits and features, the bar of
tests/test_convert.py for a whole converted model; the two frameworks sum
convolutions in different orders (and the JAX stem runs its space-to-depth
rewrite), so the outputs agree up to fp reassociation only. On the CPU the
port's kernel wrappers take their plain versions; the JAX side runs its
Pallas kernels in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models.attention import AttentionGate as JaxGate
from segtpu.models.attention import ChannelAttention as JaxChannelAttention
from segtpu.models.backbones import make_encoder as jax_make_encoder
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.models.attention import AttentionGate, ChannelAttention
from segtpu_torch.models.backbones import make_encoder
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from torch_jax_init import drawn_variables

ATOL = 2e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).contiguous(
            memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize(params, stats, seed):
    """Trained-looking variables: BN running stats, BN scales and every
    bias drawn from a seeded numpy generator, so the BN folds and biases
    are exercised with non-trivial values."""
    r = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "mean":
            return (r.normal(size=a.shape) * 0.05).astype(np.float32)
        return r.uniform(0.8, 1.2, a.shape).astype(np.float32)

    def param(path, a):
        a = np.array(a, np.float32)
        if path[-1].key == "scale":
            return r.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if path[-1].key == "bias":
            return a + (r.normal(size=a.shape) * 0.05).astype(np.float32)
        return a

    tmap = jax.tree_util.tree_map_with_path
    return tmap(param, params), tmap(stat, stats)


@functools.lru_cache(maxsize=None)
def _jax_variables(backbone, use_attention, n_classes=1,
                   final_bias_prior=None):
    m = JaxUNet(backbone=backbone, use_attention=use_attention,
                n_classes=n_classes, final_bias_prior=final_bias_prior)
    p, s = drawn_variables(m, 0, (1, 64, 64, 1))
    return _randomize(p, s, seed=n_classes + 2 * use_attention)


def _models(backbone, use_attention, *, n_classes=1, final_bias_prior=None,
            fuse_gate=True, fuse_kernel=True, fuse_head=True):
    """(JAX model, its variables, port model loaded with the same weights)
    with matching flags; fusion thresholds at 0 so every level fuses."""
    p, s = _jax_variables(backbone, use_attention, n_classes,
                          final_bias_prior)
    jm = JaxUNet(backbone=backbone, use_attention=use_attention,
                 n_classes=n_classes, final_bias_prior=final_bias_prior,
                 fuse="pallas" if fuse_kernel else "none", fuse_min_cin=0,
                 fuse_min_work=0, fuse_head=fuse_head, fuse_gate=fuse_gate)
    tm = UNetWithBackbone(n_classes=n_classes, backbone=backbone,
                          use_attention=use_attention,
                          final_bias_prior=final_bias_prior,
                          fuse="kernel" if fuse_kernel else "none",
                          fuse_min_cin=0, fuse_min_work=0,
                          fuse_head=fuse_head, fuse_gate=fuse_gate,
                          device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, backbone, use_attention,
                                           device="cpu"), strict=True)
    return jm, {"params": p, "batch_stats": s}, tm.eval()


def _jit_apply(jm, variables, x, **kw):
    """The JAX model's eval forward, jit-compiled (a third of the time of
    the op-by-op forward, Pallas kernels in interpret mode included)."""
    return jax.jit(lambda v, x: jm.apply(v, x, train=False, **kw))(
        variables, jnp.asarray(x))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_attention_gate_module_matches_jax(rng, fused):
    g = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    gate = JaxGate(f_int=8)
    v = gate.init(jax.random.key(0), jnp.asarray(g), jnp.asarray(x),
                  train=False)
    p, s = _randomize(jax.tree.map(np.asarray, v["params"]),
                      jax.tree.map(np.asarray, v["batch_stats"]), seed=3)
    p = jax.tree.map(lambda a: a * 1.5, p)      # larger pre-sigmoid range
    ref = gate.apply({"params": p, "batch_stats": s}, jnp.asarray(g),
                     jnp.asarray(x), train=False, fused=fused)

    tg = AttentionGate(16, 12, 8, device="cpu")
    sd = {}
    for i, name in enumerate(("W_g", "W_x", "psi")):
        sd[f"{name}.0.weight"] = np.transpose(p[name]["kernel"], (3, 2, 0, 1))
        sd[f"{name}.0.bias"] = p[name]["bias"]
        bn = f"BatchNorm_{i}"
        sd[f"{name}.1.weight"] = p[bn]["scale"]
        sd[f"{name}.1.bias"] = p[bn]["bias"]
        sd[f"{name}.1.running_mean"] = s[bn]["mean"]
        sd[f"{name}.1.running_var"] = s[bn]["var"]
        sd[f"{name}.1.num_batches_tracked"] = np.array(0)
    tg.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()}, strict=True)
    tg.eval()
    with torch.no_grad():
        got = tg(_nchw(g), _nchw(x), fused=fused)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def _random_gate(seed, f_g=16, f_l=12, f_int=8):
    """An eval-mode gate with non-trivial BatchNorm affines and running
    statistics, from a seeded torch generator."""
    torch.manual_seed(seed)
    gate = AttentionGate(f_g, f_l, f_int, device="cpu")
    with torch.no_grad():
        for bn in (gate.W_g[1], gate.W_x[1], gate.psi[1]):
            bn.weight.uniform_(0.8, 1.2)
            bn.bias.normal_(0.0, 0.1)
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    return gate.eval()


def _gate_io(rng):
    return (_nchw(rng.normal(size=(2, 8, 8, 16)).astype(np.float32)),
            _nchw(rng.normal(size=(2, 8, 8, 12)).astype(np.float32)))


def _fused_matches_unfused(gate, g, x):
    with torch.no_grad():
        fused = gate(g, x, fused=True)
        unfused = gate(g, x, fused=False)
    # atol 1e-5: the gate's bar against the JAX module above
    np.testing.assert_allclose(_nhwc(fused), _nhwc(unfused), atol=1e-5)


def test_gate_fold_is_cached_and_equals_a_fresh_fold():
    gate = _random_gate(0)
    with torch.no_grad():
        cached = gate.folded()
        assert gate.folded() is cached      # the second forward's fold
        fresh = gate.fold()
    for a, b in zip(cached, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gate.to(torch.bfloat16)                 # new storage and dtype
    with torch.no_grad():
        ag, ax, bh, apsi, bpsi = gate.folded()
    assert (ag.dtype, ax.dtype, apsi.dtype) == (torch.bfloat16,) * 3
    assert (bh.dtype, bpsi.dtype) == (torch.float32,) * 2


def _fused_input_grad(gate, g, x):
    """Gradient of the eval-mode fused gate's output sum w.r.t. x, with
    grad enabled (a saliency map)."""
    x = x.clone().requires_grad_(True)
    gate(g, x, fused=True).sum().backward()
    return x.grad


def test_gate_fold_with_grad_backpropagates_every_forward(rng):
    """With grad enabled each fused forward folds afresh (the fold is
    detached; the graph runs through g and x): two forwards and
    backwards in a row both run, and agree with the unfused gate's input
    gradient."""
    gate = _random_gate(0)
    g, x = _gate_io(rng)
    first = _fused_input_grad(gate, g, x)
    second = _fused_input_grad(gate, g, x)
    x_ref = x.clone().requires_grad_(True)
    gate(g, x_ref, fused=False).sum().backward()
    for got in (first, second):
        # atol 1e-5: the gate's bar against the JAX module above
        np.testing.assert_allclose(got.numpy(), x_ref.grad.numpy(),
                                   atol=1e-5)


def test_gate_fold_cached_under_inference_mode_then_used_with_grad(rng):
    """A fold cached under ``inference_mode`` (as ``predict_proba``
    fills it) is not handed to a later forward that records grad."""
    gate = _random_gate(0)
    g, x = _gate_io(rng)
    with torch.inference_mode():
        gate(g, x, fused=True)
    assert gate._folded is not None
    got = _fused_input_grad(gate, g, x)
    x_ref = x.clone().requires_grad_(True)
    gate(g, x_ref, fused=False).sum().backward()
    np.testing.assert_allclose(got.numpy(), x_ref.grad.numpy(), atol=1e-5)
    _fused_matches_unfused(gate, g, x)   # and the cache still serves no_grad


def test_gate_fold_cache_follows_load_state_dict(rng):
    """``load_state_dict`` copies into the same storage: the fold cached
    before it must not survive it."""
    gate, other = _random_gate(0), _random_gate(1)
    g, x = _gate_io(rng)
    _fused_matches_unfused(gate, g, x)
    before = gate.folded()
    gate.load_state_dict(other.state_dict())
    assert gate.folded() is not before
    _fused_matches_unfused(gate, g, x)


def test_gate_fold_cache_follows_train_mode_batchnorm_update(rng):
    """A train-mode forward moves the BatchNorm running statistics in
    place; the next fused forward folds them anew."""
    gate = _random_gate(0)
    g, x = _gate_io(rng)
    _fused_matches_unfused(gate, g, x)
    mean = gate.W_g[1].running_mean.clone()
    gate.train()
    with torch.no_grad():
        gate(g * 2.0 + 1.0, x, fused=True)   # training: the unfused path
    gate.eval()
    assert not torch.equal(gate.W_g[1].running_mean, mean)
    _fused_matches_unfused(gate, g, x)


def test_channel_attention_matches_jax(rng):
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    ca = JaxChannelAttention()
    v = ca.init(jax.random.key(1), jnp.asarray(x))
    ref = ca.apply(v, jnp.asarray(x))

    tca = ChannelAttention(32, device="cpu")
    w = v["params"]
    tca.load_state_dict({
        "fc.0.weight": torch.from_numpy(np.ascontiguousarray(np.transpose(
            np.asarray(w["fc1"]["kernel"]), (3, 2, 0, 1)))),
        "fc.2.weight": torch.from_numpy(np.ascontiguousarray(np.transpose(
            np.asarray(w["fc2"]["kernel"]), (3, 2, 0, 1))))}, strict=True)
    with torch.no_grad():
        got = tca(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_encoder_features_match_jax(rng):
    p, s = _jax_variables("resnet_tiny", False)
    x = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    ref = jax_make_encoder("resnet_tiny").apply(
        {"params": p["encoder"], "batch_stats": s["encoder"]},
        jnp.asarray(x), False)

    enc = make_encoder("resnet_tiny", device="cpu")
    sd = state_dict_from_jax(p, s, "resnet_tiny", False, device="cpu")
    enc.load_state_dict({k: v for k, v in sd.items()
                         if k.split(".")[0] in ("input_conv", "bn1", "enc1",
                                                "enc2", "enc3", "enc4")},
                        strict=True)
    enc.eval()
    with torch.no_grad():
        got = enc(_nchw(x))
    assert len(got) == 5
    for r, t in zip(ref, got):
        assert t.shape[1] == r.shape[-1]
        np.testing.assert_allclose(_nhwc(t), np.asarray(r), atol=ATOL)


def test_stem_s2d_map_and_weight_match_jax():
    """``stem_s2d_weight`` (pad and ``pixel_unshuffle`` of the 7×7 kernel)
    is the JAX package's constant map applied to the kernel, exactly."""
    from segtpu.models.backbones import _stem_s2d_map as jax_map
    from segtpu_torch.models.backbones import stem_s2d_weight
    w7 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64, 1, 7, 7)))
    want = torch.einsum("uvabp,cuv->cpab",
                        torch.from_numpy(np.asarray(jax_map())).double(),
                        w7[:, 0])
    assert torch.equal(stem_s2d_weight(w7), want)


@pytest.mark.parametrize("size", [64, 63], ids=["even", "odd-falls-back"])
def test_stem_s2d_matches_jax_and_the_plain_stem(rng, size):
    """tests/test_models.py::test_stem_s2d_parity for the port: at
    inference the s2d stem's features equal the JAX encoder's
    (``stem_s2d=True``) and the port's plain stem's within 2e-5; an odd
    size runs the plain stem (bit for bit)."""
    p, s = _jax_variables("resnet_tiny", False)
    x = rng.normal(size=(2, size, size, 1)).astype(np.float32)
    ref = jax_make_encoder("resnet_tiny").apply(
        {"params": p["encoder"], "batch_stats": s["encoder"]},
        jnp.asarray(x), False)
    enc = make_encoder("resnet_tiny", device="cpu")
    sd = state_dict_from_jax(p, s, "resnet_tiny", False, device="cpu")
    enc.load_state_dict({k: v for k, v in sd.items()
                         if k.split(".")[0] in ("input_conv", "bn1", "enc1",
                                                "enc2", "enc3", "enc4")})
    enc.eval()
    with torch.no_grad():
        got = enc(_nchw(x))
        enc.input_conv.s2d = False
        plain = enc(_nchw(x))
    for g, r, q in zip(got, ref, plain):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(_nhwc(g), _nhwc(q), atol=2e-5, rtol=2e-5)
        if size % 2:
            assert torch.equal(g, q)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_flagship_resnet34_matches_jax(rng, use_attention):
    """The flagship model's forward with its kernels routed in (the gate
    with attention, the upsample at every level without), resnet34 at
    64², against the JAX model with the same flags."""
    jm, jv, tm = _models("resnet34", use_attention)
    x = rng.normal(size=(1, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(_jit_apply(jm, jv, x))
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


def test_fuse_routing_matches_jax_thresholds():
    """The default thresholds (fuse_min_cin=96, fuse_min_work=16384) pick
    the same levels as the JAX model: at B=16, 512², levels 3 and 2."""
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=False,
                          device="cpu").eval()
    picked = [lvl for lvl, (c, hw) in zip(
        (4, 3, 2, 1), ((512, 16), (256, 32), (128, 64), (64, 128)))
        if tm._fused_level(torch.empty((16, c, hw, hw), device="meta"))]
    assert picked == [3, 2]
    tm.train()
    assert not tm._fused_level(torch.empty((16, 256, 32, 32), device="meta"))
