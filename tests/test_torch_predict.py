"""The port's inference entry points (segtpu_torch.infer.predict) vs
segtpu.infer.predict on the same weights, and the port's device rule."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from segtpu.infer.predict import predict as jax_predict
from segtpu.infer.predict import predict_proba as jax_predict_proba
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch import resolve_device
from segtpu_torch.infer.predict import predict, predict_proba
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from torch_jax_init import drawn_variables


def _pair(n_classes):
    jm = JaxUNet(backbone="resnet_tiny", use_attention=True,
                 n_classes=n_classes, fuse_gate=True)
    p, s = drawn_variables(jm, n_classes, (1, 32, 32, 1))
    r = np.random.default_rng(5)
    s = jax.tree_util.tree_map_with_path(
        lambda k, a: (r.normal(size=a.shape) * 0.05 if k[-1].key == "mean"
                      else r.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        s)
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=True,
                          n_classes=n_classes, device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", True,
                                           device="cpu"), strict=True)
    return jm, SimpleNamespace(params=p, batch_stats=s), tm


@pytest.mark.parametrize("n_classes", [1, 2], ids=["sigmoid", "softmax"])
def test_predict_matches_jax(rng, n_classes):
    jm, state, tm = _pair(n_classes)
    images = rng.uniform(0, 1, size=(2, 32, 32)).astype(np.float32)
    want = np.asarray(jax_predict_proba(jm, state, images[..., None]))
    got = predict_proba(tm, images, device="cpu")
    assert got.shape == (2, 32, 32, n_classes) and got.dtype == np.float32
    # probabilities: the atol 2e-4 logit bar, times the sigmoid's and
    # softmax's slope of at most 1/4 and 1/2
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(
        predict_proba(tm, images[..., None], device="cpu"), got)

    masks = predict(tm, images, device="cpu")
    ref_masks = jax_predict(jm, state, images[..., None])
    assert masks.dtype == np.uint8
    decided = np.abs(want - 0.5) > 1e-3     # away from the threshold
    np.testing.assert_array_equal(masks[decided], ref_masks[decided])


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNetWithBackbone(backbone="resnet_tiny")
    tm = UNetWithBackbone(backbone="resnet_tiny", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_proba(tm, np.zeros((1, 32, 32), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict(tm, np.zeros((1, 32, 32), np.float32))
    assert resolve_device("cpu") == torch.device("cpu")


def test_predict_rejects_bad_input_shape():
    tm = UNetWithBackbone(backbone="resnet_tiny", device="cpu")
    with pytest.raises(ValueError, match="images must be"):
        predict_proba(tm, np.zeros((32, 32), np.float32), device="cpu")
