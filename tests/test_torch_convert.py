"""The JAX→port weight converter (segtpu_torch.models.convert) and the
port's reference key naming."""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from segtpu.models.torch_convert import load_reference_checkpoint
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu_torch.models.convert import (conv_transpose_weight,
                                         state_dict_from_jax)
from segtpu_torch.models.unet import UNetWithBackbone

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from torch_baseline import build_model  # noqa: E402


def _random_variables(backbone, use_attention, seed=0):
    """JAX variables with every leaf drawn from a seeded generator, so a
    leaf mapped to the wrong place cannot go unnoticed."""
    m = JaxUNet(backbone=backbone, use_attention=use_attention)
    # the variables' shapes alone (``create_model_state`` traced, not
    # compiled): every leaf is drawn below
    p, s = jax.eval_shape(
        lambda k: create_model_state(m, k, (1, 32, 32, 1)), jax.random.key(0))
    r = np.random.default_rng(seed)
    draw = lambda a: r.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
    return jax.tree.map(draw, p), jax.tree.map(draw, s)


@pytest.mark.parametrize("backbone,use_attention", [
    ("resnet_tiny", True), ("resnet_tiny", False), ("resnet34", True),
    ("resnet34", False)])
def test_state_dict_from_jax_loads_strict(backbone, use_attention):
    p, s = _random_variables(backbone, use_attention)
    sd = state_dict_from_jax(p, s, backbone, use_attention, device="cpu")
    tm = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                          device="cpu")
    res = tm.load_state_dict(sd, strict=True)
    assert res.missing_keys == [] and res.unexpected_keys == []
    own = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    for k, v in sd.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_reference_checkpoint_loads_strict(use_attention):
    """A reference-style PyTorch model's state_dict loads into the port
    with strict=True, and both compute the same logits."""
    torch.manual_seed(0)
    ref = build_model(use_attention=use_attention).eval()
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.05)
                mod.running_var.uniform_(0.8, 1.2)
    tm = UNetWithBackbone(backbone="resnet34", use_attention=use_attention,
                          device="cpu")
    res = tm.load_state_dict(ref.state_dict(), strict=True)
    assert res.missing_keys == [] and res.unexpected_keys == []
    tm.eval()
    x = torch.randn(1, 1, 64, 64)
    with torch.no_grad():
        want = ref(x)
        got = tm(x.contiguous(memory_format=torch.channels_last))
    # both are PyTorch; only the head contraction and the gate fold
    # reassociate sums
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_resnet34_round_trip_is_exact(use_attention):
    """JAX variables → state_dict_from_jax → load_reference_checkpoint
    gives back every leaf bit for bit."""
    p, s = _random_variables("resnet34", use_attention, seed=1)
    sd = state_dict_from_jax(p, s, "resnet34", use_attention, device="cpu")
    p2, s2 = load_reference_checkpoint(sd, "resnet34", use_attention)
    for want, got in ((p, p2), (s, s2)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_conv_transpose_weight_flips_taps(rng):
    k = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    w = conv_transpose_weight(k)
    assert w.shape == (3, 5, 2, 2)
    for dy in range(2):
        for dx in range(2):
            np.testing.assert_array_equal(w[:, :, dy, dx], k[1 - dy, 1 - dx])
