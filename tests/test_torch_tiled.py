"""The port's tiled inference (segtpu_torch.infer.tiled) against the JAX
package's (segtpu.infer.tiled), case for case with tests/test_infer.py,
on the same numpy inputs; the real-model cases on the same weights (moved
across by ``state_dict_from_jax``).

Tolerances, and why:
- elementwise ``apply_fn``s (2·x, tanh, affine): atol 1e-5 against JAX
  and against the exact answer, as tests/test_infer.py (the blend divides
  by a weight total, a few f32 roundings of O(1) values);
- the blend window and the tile origins: equal to JAX's;
- the U-Net (resnet_tiny, f32): probabilities atol 1e-4, the bar of
  tests/test_torch_predict.py (logits within 2e-4 times the sigmoid's
  slope of at most 1/4), since the two packages sum convolutions in
  other orders;
- halo tiles against the model's direct forward of the same padded
  window, within one package: atol 1e-5 (the same ops on the same
  window; only the batch they run in differs).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from segtpu.infer import tiled as jt
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.infer import tiled as tt
from segtpu_torch.infer.predict import nhwc_forward
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from torch_jax_init import drawn_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(shape, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return a, jnp.asarray(a), torch.from_numpy(a.copy())


def _tanh_j(x):
    return jnp.tanh(x * 1.3 + 0.2)


def _tanh_t(x):
    return torch.tanh(x * 1.3 + 0.2)


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def test_blend_window_partition_of_unity():
    tile, overlap = 64, 16
    w = tt._blend_window(tile, overlap)
    np.testing.assert_array_equal(w, jt._blend_window(tile, overlap))
    stride = tile - overlap
    col = w[tile // 2, :overlap] + w[tile // 2, stride:]
    np.testing.assert_allclose(col, 1.0, atol=1e-6)


@pytest.mark.parametrize("size,tile,stride",
                         [(100, 64, 48), (512, 128, 96), (64, 64, 48)])
def test_tile_origins_cover(size, tile, stride):
    org = tt._tile_origins(size, tile, stride)
    np.testing.assert_array_equal(org, jt._tile_origins(size, tile, stride))
    covered = np.zeros(size, bool)
    for o in org:
        covered[o:o + tile] = True
    assert covered.all() and org[-1] + tile <= size
    np.testing.assert_array_equal(
        tt._blend_weight_sum(size, size, tile, tile - stride, org, org),
        jt._blend_weight_sum(size, size, tile, tile - stride, org, org))


def test_tiled_identity_function_exact():
    a, j, t = _both((200, 168, 1))
    kw = dict(tile=64, overlap=16, batch_tiles=4)
    got = tt.make_tiled_predictor(lambda x: x * 2.0, **kw)(t)
    assert got.dtype == torch.float32 and got.shape == (200, 168, 1)
    _close(got, a * 2.0)
    _close(got, jt.make_tiled_predictor(lambda x: x * 2.0, **kw)(j))


def test_tiled_multichannel_output():
    img = np.ones((96, 96, 1), np.float32)
    kw = dict(tile=64, overlap=16, batch_tiles=2)
    got = tt.make_tiled_predictor(
        lambda x: torch.cat([x, x * 2, x * 3], dim=-1), **kw)(img)
    assert got.shape == (96, 96, 3)
    _close(got[..., 2], np.full((96, 96), 3.0))
    _close(got, jt.make_tiled_predictor(
        lambda x: jnp.concatenate([x, x * 2, x * 3], axis=-1), **kw)(img))


@pytest.mark.parametrize("mode", ["blend", "halo"])
@pytest.mark.parametrize("batch_tiles", [4, 32],
                         ids=["scan-path", "one-forward"])
def test_tiled_predict_many_matches_single(mode, batch_tiles):
    """Tiles batched across images == per-image tiling == JAX's
    ``make_tiled_predictor_many`` (its vmap of the single predictor)."""
    a, j, t = _both((3, 96, 80, 1), seed=1)
    kw = dict(tile=32, overlap=8, batch_tiles=batch_tiles, mode=mode)
    single = tt.make_tiled_predictor(_tanh_t, **kw)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return _tanh_t(x)

    got = tt.make_tiled_predictor_many(counted, **kw)(t)
    _close(got, torch.stack([single(im) for im in t]))
    _close(got, jt.make_tiled_predictor_many(_tanh_j, **kw)(j))
    # each forward holds the same tile slots of all three images
    assert all(n % 3 == 0 for n in calls)


def _pair(use_attention, backbone="resnet_tiny", size=32, seed=0,
          n_classes=1):
    """A JAX U-Net and the port's, on the same weights, BatchNorm
    statistics randomized so that the inference BatchNorms do work."""
    jm = JaxUNet(backbone=backbone, use_attention=use_attention,
                 n_classes=n_classes)
    p, s = drawn_variables(jm, seed, (1, size, size, 1))
    r = np.random.default_rng(seed + 5)
    s = jax.tree_util.tree_map_with_path(
        lambda k, v: (r.normal(size=v.shape) * 0.05 if k[-1].key == "mean"
                      else r.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        s)
    tm = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                          n_classes=n_classes, device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, backbone, use_attention,
                                           device="cpu"), strict=True)
    return jm, SimpleNamespace(params=p, batch_stats=s), tm.eval()


@pytest.mark.parametrize("mode,use_attention",
                         [("blend", False), ("halo", True)],
                         ids=["blend-no-attention", "halo-attention"])
def test_tiled_with_real_model(mode, use_attention):
    jm, state, tm = _pair(use_attention)
    img = np.random.default_rng(1).random((80, 72)).astype(np.float32)
    kw = dict(tile=32, overlap=16, batch_tiles=2, mode=mode)
    got = tt.tiled_predict(tm, img, device="cpu", **kw)
    assert got.shape == (80, 72, 1) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    _close(got, jt.tiled_predict(jm, state, img, **kw), atol=1e-4)


def test_tiled_multiclass_with_real_model():
    """n_classes=3: the blended logits through the channel softmax, with
    attention, against the JAX package's; the classes sum to 1."""
    jm, state, tm = _pair(True, n_classes=3)
    img = np.random.default_rng(4).random((64, 48)).astype(np.float32)
    kw = dict(tile=32, overlap=16, batch_tiles=4, mode="blend")
    got = tt.tiled_predict(tm, img, device="cpu", **kw)
    assert got.shape == (64, 48, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    _close(got, jt.tiled_predict(jm, state, img, **kw), atol=1e-4)


def test_tiled_halo_tiles_are_the_direct_forward_of_their_window():
    """Halo composition: each output tile is the model's own forward of
    its padded window, centre-cropped (the window cut by hand here)."""
    _, _, tm = _pair(True)
    img = np.random.default_rng(2).random((64, 96, 1)).astype(np.float32)
    tile, halo = 32, 16                      # overlap 16 → halo 8 → 16
    with torch.inference_mode():
        got = tt.make_tiled_predictor(
            lambda x: nhwc_forward(tm, x), tile=tile, overlap=16,
            mode="halo")(img)
        padded = np.pad(img, ((halo, halo), (halo, halo), (0, 0)),
                        mode="reflect")
        for oy in range(0, 64, tile):
            for ox in range(0, 96, tile):
                win = torch.from_numpy(np.ascontiguousarray(
                    padded[None, oy:oy + tile + 2 * halo,
                           ox:ox + tile + 2 * halo]))
                want = nhwc_forward(tm, win)[0, halo:-halo, halo:-halo]
                _close(got[oy:oy + tile, ox:ox + tile], want)


def test_tiled_halo_identity_exact():
    a, j, t = _both((100, 88, 1), seed=3)
    kw = dict(tile=32, overlap=16, batch_tiles=4, mode="halo")
    got = tt.make_tiled_predictor(lambda x: x * 2.0, **kw)(t)
    assert got.shape == (100, 88, 1)
    _close(got, a * 2.0)
    _close(got, jt.make_tiled_predictor(lambda x: x * 2.0, **kw)(j))


def test_tiled_halo_matches_dense_for_small_receptive_field():
    """A 2-layer 3×3 conv stack has receptive radius 2 ≤ halo 4: halo
    tiling reproduces the dense forward on every pixel ≥2 from the border
    (border pixels differ by pad policy), in both packages."""
    rng = np.random.default_rng(4)
    k1 = rng.normal(size=(3, 3, 1, 4), scale=0.5).astype(np.float32)
    k2 = rng.normal(size=(3, 3, 4, 2), scale=0.5).astype(np.float32)
    w1 = torch.from_numpy(np.transpose(k1, (3, 2, 0, 1)).copy())
    w2 = torch.from_numpy(np.transpose(k2, (3, 2, 0, 1)).copy())

    def apply_t(x):
        y = torch.tanh(F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1))
        return F.conv2d(y, w2, padding=1).permute(0, 2, 3, 1)

    def apply_j(x):
        dn = ("NHWC", "HWIO", "NHWC")
        y = jnp.tanh(jax.lax.conv_general_dilated(x, k1, (1, 1), "SAME",
                                                  dimension_numbers=dn))
        return jax.lax.conv_general_dilated(y, k2, (1, 1), "SAME",
                                            dimension_numbers=dn)

    a, j, t = _both((96, 96, 1), seed=5)
    dense = apply_t(t[None])[0]
    kw = dict(tile=32, overlap=8, batch_tiles=4, mode="halo")
    got = tt.make_tiled_predictor(apply_t, **kw)(t)
    assert got.shape == dense.shape
    _close(got[2:-2, 2:-2], dense[2:-2, 2:-2])
    _close(got, jt.make_tiled_predictor(apply_j, **kw)(j))


def test_tiled_halo_reshape_path_matches_scan_path():
    a, j, t = _both((128, 96, 1), seed=6)
    kw = dict(tile=32, overlap=8, mode="halo")
    one_shot = tt.make_tiled_predictor(_tanh_t, batch_tiles=32, **kw)(t)
    scanned = tt.make_tiled_predictor(_tanh_t, batch_tiles=4, **kw)(t)
    np.testing.assert_allclose(one_shot.numpy(), scanned.numpy(), atol=1e-6)
    _close(one_shot, jt.make_tiled_predictor(_tanh_j, batch_tiles=4,
                                             **kw)(j))


@pytest.mark.parametrize("mode", ["blend", "halo"])
def test_tiled_auto_batch_tiles_matches_explicit(mode):
    a, j, t = _both((128, 96, 1), seed=7)
    kw = dict(tile=32, overlap=8, mode=mode)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return _tanh_t(x)

    auto = tt.make_tiled_predictor(counted, **kw)(t)
    assert len(calls) == 1            # ≤ 32 tiles: one forward per image
    _close(auto, tt.make_tiled_predictor(_tanh_t, batch_tiles=4, **kw)(t))
    _close(auto, jt.make_tiled_predictor(_tanh_j, **kw)(j))


def test_tiled_auto_batch_cap_bounds_memory():
    """Above 32 tiles the auto batch still loops (a cap, not one
    forward): the 12 × 12 blend tiles of a 288² image (stride 24) run as
    5 batches of 29, the last with one zero-weight duplicate."""
    a, j, t = _both((288, 288, 1), seed=8)
    calls = []

    def f(x):
        calls.append(x.shape[0])
        return x * 0.5 + 0.1

    kw = dict(tile=32, overlap=8, mode="blend")
    auto = tt.make_tiled_predictor(f, **kw)(t)
    assert calls == [29] * 5
    _close(auto, tt.make_tiled_predictor(f, batch_tiles=8, **kw)(t))
    _close(auto, jt.make_tiled_predictor(lambda x: x * 0.5 + 0.1, **kw)(j))


def test_tiled_bad_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        tt.make_tiled_predictor(lambda x: x, mode="bogus")
    with pytest.raises(ValueError, match="mode"):
        tt.make_tiled_predictor_many(lambda x: x, mode="bogus")


def test_tiled_small_image_pads_edge():
    """Images smaller than about half the tile cannot reflect-pad: the
    predictor falls back to edge padding, as JAX's."""
    img = (np.arange(20 * 20, dtype=np.float32).reshape(20, 20, 1) / 400.0)
    for mode in ("blend", "halo"):
        got = tt.make_tiled_predictor(lambda x: x, tile=64, overlap=16,
                                      mode=mode)(img)
        assert got.shape == (20, 20, 1)
        _close(got, img)
        _close(got, jt.make_tiled_predictor(lambda x: x, tile=64,
                                            overlap=16, mode=mode)(img))


def test_shard_tiles_axis_names_multi_device_item(tmp_path):
    """Tile batches sharded over a 2-rank gloo mesh equal the unsharded
    tiler within 1e-5 (tests/test_parallel.py's bar): blend, and halo with
    both assembly paths, batches that do not divide by 2 included. With
    no current mesh the sharded predictor refuses, naming what it needs."""
    from torch_dist_worker import launch
    with pytest.raises(RuntimeError, match="with mesh"):
        tt.make_tiled_predictor(lambda x: x, tile=32, overlap=8,
                                shard_tiles_axis="data")(np.zeros(
                                    (40, 40, 1), np.float32))
    img = np.random.default_rng(0).normal(size=(96, 96, 1)).astype(
        np.float32)
    torch.save({"img": torch.from_numpy(img)}, tmp_path / "inputs.pt")
    for rank in launch("tiled", 2, tmp_path):
        assert len(rank) == 4
        for case, err in rank.items():
            assert err <= 1e-5, (case, err)
