"""The port's D4 test-time augmentation (segtpu_torch.infer.tta) against
the JAX package's (segtpu.infer.tta), case for case with
tests/test_tta.py, on the same numpy inputs and the same U-Net weights
(resnet_tiny, moved across by ``state_dict_from_jax``).

Tolerances, and why:
- the group's transforms: exact (pure relayouts), and equal to JAX's;
- TTA and halo-tiled TTA against JAX, f32: probabilities atol 1e-4, the bar of
  tests/test_torch_predict.py (the packages sum convolutions in other
  orders; averaging 8 maps does not widen it);
- TTA against a manual average of the port's own forwards: atol 1e-6
  (the same forwards, summed in the same order);
- the kernel path (the fused gate) against the unfused gate: atol 1e-5
  (the gate's BatchNorms folded, reassociated f32).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.infer import tta as jtta
from segtpu.infer.tiled import tiled_predict as jax_tiled_predict
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.infer import tta as ttta
from segtpu_torch.infer.predict import predict_proba
from segtpu_torch.infer.tiled import tiled_predict
from segtpu_torch.models import attention as attention_module
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from torch_jax_init import drawn_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """A JAX U-Net and the port's on the same weights, BatchNorm
    statistics randomized."""
    jm = JaxUNet(backbone="resnet_tiny", use_attention=True)
    p, s = drawn_variables(jm, 3, (1, 32, 32, 1))
    r = np.random.default_rng(8)
    s = jax.tree_util.tree_map_with_path(
        lambda k, v: (r.normal(size=v.shape) * 0.05 if k[-1].key == "mean"
                      else r.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        s)
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=True,
                          device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", True,
                                           device="cpu"), strict=True)
    return jm, SimpleNamespace(params=p, batch_stats=s), tm.eval()


def test_d4_roundtrip_exact(rng):
    a = rng.random((2, 8, 8, 3)).astype(np.float32)
    x = torch.from_numpy(a)
    for k, t in ttta.D4_ELEMENTS:
        np.testing.assert_array_equal(
            ttta._invert_d4(ttta._apply_d4(x, k, t), k, t).numpy(), a)
        # each element acts as JAX's does
        np.testing.assert_array_equal(
            ttta._apply_d4(x, k, t).numpy(),
            np.asarray(jtta._apply_d4(jnp.asarray(a), k, t)))
    assert ttta.D4_ELEMENTS == jtta.D4_ELEMENTS
    assert ttta.tta_elements(False) == jtta.tta_elements(False)


def test_d4_elements_distinct(rng):
    x = torch.from_numpy(rng.random((1, 5, 5, 1)).astype(np.float32))
    images = [ttta._apply_d4(x, k, t).contiguous().numpy().tobytes()
              for k, t in ttta.D4_ELEMENTS]
    assert len(set(images)) == 8


def test_tta_matches_manual_average_square(pair, rng):
    jm, state, tm = pair
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    got = ttta.tta_predict_proba(tm, x, device="cpu")
    assert got.shape == (2, 32, 32, 1) and got.dtype == np.float32
    manual = np.mean([ttta._invert_d4(torch.from_numpy(predict_proba(
        tm, ttta._apply_d4(torch.from_numpy(x), k, t).numpy(),
        device="cpu")), k, t).numpy() for k, t in ttta.D4_ELEMENTS], axis=0)
    np.testing.assert_allclose(got, manual, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jtta.tta_predict_proba(jm, state, x)), atol=1e-4)


def test_tta_rectangular_uses_flips(pair, rng):
    jm, state, tm = pair
    x = rng.random((1, 32, 64, 1)).astype(np.float32)
    got = ttta.tta_predict_proba(tm, x, device="cpu")
    assert got.shape == (1, 32, 64, 1)
    assert len(ttta.tta_elements(square=False)) == 4
    outs = []
    for fh, fv in ttta.tta_elements(square=False):
        v = ttta._apply_flips(torch.from_numpy(x), fh, fv).numpy()
        outs.append(ttta._apply_flips(torch.from_numpy(
            predict_proba(tm, v, device="cpu")), fh, fv).numpy())
    np.testing.assert_allclose(got, np.mean(outs, axis=0), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jtta.tta_predict_proba(jm, state, x)), atol=1e-4)


class _Pointwise(torch.nn.Module):
    """An orientation-equivariant model: 2x − 1 per pixel."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, x):
        return x * self.scale - 1.0


def test_tta_equivariant_function_is_identity_average(rng):
    x = rng.random((1, 8, 8, 1)).astype(np.float32)
    got = ttta.tta_predict_proba(_Pointwise(), x, device="cpu")
    np.testing.assert_allclose(got, 1 / (1 + np.exp(-(x * 2.0 - 1.0))),
                               atol=1e-6)


def test_tta_predict_thresholds(pair, rng):
    _, _, tm = pair
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    masks = ttta.tta_predict(tm, x, device="cpu")
    assert masks.dtype == np.uint8 and set(np.unique(masks)) <= {0, 1}
    np.testing.assert_array_equal(
        masks, (ttta.tta_predict_proba(tm, x, device="cpu") > 0.5))


def test_tiled_tta_single_tile_matches_batch_tta(pair, rng):
    """On an image that is exactly one tile, tiled TTA is batch TTA
    (blending is a no-op there)."""
    _, _, tm = pair
    img = rng.random((32, 32, 1)).astype(np.float32)
    got = tiled_predict(tm, img, tile=32, overlap=0, batch_tiles=1,
                        tta=True, device="cpu")
    want = ttta.tta_predict_proba(tm, img[None], device="cpu")[0]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tiled_tta_multi_tile_shape_and_range(pair, rng):
    _, _, tm = pair
    img = rng.random((48, 56, 1)).astype(np.float32)
    got = tiled_predict(tm, img, tile=32, overlap=16, batch_tiles=2,
                        tta=True, device="cpu")
    assert got.shape == (48, 56, 1)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_tiled_tta_halo_mode(pair, rng):
    """TTA composes with halo tiling: each square haloed tile gets its D4
    average before the centre crop; a calibrated probability map equal to
    JAX's on a ragged, multi-tile image."""
    jm, state, tm = pair
    img = rng.random((48, 56, 1)).astype(np.float32)
    kw = dict(tile=32, overlap=16, batch_tiles=4, tta=True, mode="halo")
    got = tiled_predict(tm, img, device="cpu", **kw)
    assert got.shape == (48, 56, 1)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, jax_tiled_predict(jm, state, img, **kw),
                               atol=1e-4)


def test_tta_rejects_non_batch(pair, rng):
    _, _, tm = pair
    with pytest.raises(ValueError):
        ttta.tta_predict_proba(tm, rng.random((8, 8, 1)), device="cpu")
    with pytest.raises(ValueError, match="square"):
        ttta.d4_average_apply(lambda v: v)(torch.zeros(1, 8, 16, 1))


def test_tta_rotated_views_reach_the_gate_contiguous(pair, rng):
    """Each transformed batch reaches the fused gate as NHWC-contiguous
    operands (rot90/transpose/flip give strided views, which the gate's
    checks refuse), and the kernel path equals the unfused gate."""
    _, _, tm = pair
    calls = []
    real = attention_module.attention_gate

    def spy(g, x, *rest):
        calls.append((g.is_contiguous(), x.is_contiguous()))
        return real(g, x, *rest)

    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    attention_module.attention_gate = spy
    try:
        fused = ttta.tta_predict_proba(tm, x, device="cpu")
    finally:
        attention_module.attention_gate = real
    assert len(calls) == 8 * 4 and all(a and b for a, b in calls)
    tm.fuse_gate = False
    try:
        plain = ttta.tta_predict_proba(tm, x, device="cpu")
    finally:
        tm.fuse_gate = True
    np.testing.assert_allclose(fused, plain, atol=1e-5)


def test_tta_multiclass_stays_on_the_simplex(rng):
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=False,
                          n_classes=3, device="cpu").eval()
    x = rng.random((1, 32, 32, 1)).astype(np.float32)
    probs = ttta.tta_predict_proba(tm, x, device="cpu")
    assert probs.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    img = rng.random((40, 40)).astype(np.float32)
    tiled = tiled_predict(tm, img, tile=32, overlap=8, tta=True,
                          device="cpu")
    np.testing.assert_allclose(tiled.sum(-1), 1.0, atol=1e-5)
