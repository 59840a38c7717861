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
from segtpu.models.unet import create_model_state
from segtpu_torch.models.attention import AttentionGate, ChannelAttention
from segtpu_torch.models.backbones import make_encoder
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone

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
    p, s = create_model_state(m, jax.random.key(0), (1, 64, 64, 1))
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


# resnet_tiny at 64²: attention on/off × gate kernel on/off × upsample
# kernel on/off, the head contraction on/off, the bias prior, 2 classes.
UNET_CASES = {
    "attn-gatekernel": dict(use_attention=True),
    "attn-gateplain": dict(use_attention=True, fuse_gate=False),
    "attn-gatekernel-headplain": dict(use_attention=True, fuse_head=False),
    "noattn-upkernel": dict(use_attention=False),
    "noattn-upplain-headplain": dict(use_attention=False, fuse_kernel=False,
                                     fuse_head=False),
    "attn-prior": dict(use_attention=True, final_bias_prior=0.1),
    "noattn-2class": dict(use_attention=False, n_classes=2),
}


@pytest.mark.parametrize("case", list(UNET_CASES), ids=list(UNET_CASES))
def test_unet_matches_jax(rng, case):
    jm, jv, tm = _models("resnet_tiny", **UNET_CASES[case])
    x = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert np.abs(ref).max() > 50 * ATOL      # the comparison is not vacuous
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


def test_unet_return_features_matches_jax(rng):
    jm, jv, tm = _models("resnet_tiny", use_attention=True)
    x = rng.normal(size=(1, 64, 64, 1)).astype(np.float32)
    ref_out, ref_feat = jm.apply(jv, jnp.asarray(x), train=False,
                                 return_features=True)
    with torch.no_grad():
        out, feat = tm(_nchw(x), return_features=True)
    assert feat.shape == (1, 64 + 128, 8, 8)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(_nhwc(feat), np.asarray(ref_feat), atol=ATOL)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_flagship_resnet34_matches_jax(rng, use_attention):
    """The flagship model's forward with its kernels routed in (the gate
    with attention, the upsample at every level without), resnet34 at
    64², against the JAX model with the same flags."""
    jm, jv, tm = _models("resnet34", use_attention)
    x = rng.normal(size=(1, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
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
