"""The port's losses, metrics and array ops (segtpu_torch.losses,
.metrics, .ops, .data.preprocess) against the JAX package's, on the same
seeded numpy inputs, float32 on the CPU.

Tolerances:
- losses: value within rtol 1e-5 (the same f32 formulas summed in
  other orders: a mean over 2·2·16·16 elements carries ~1e-7 of
  reassociation); gradient w.r.t. the logits within rtol 1e-4 and 1e-5
  of the largest gradient (the exponential-logarithmic loss raises
  −log(·) to γ = 0.3, whose slope γ·u^(γ−1) magnifies an f32 rounding of
  u twentyfold and more);
- EDT, CLAHE, confusion counts, connected components: exact (integers,
  or the same correctly rounded f32 operations);
- metrics: within 1e-6 (f32 sums of 0/1 products, divided once);
- ``normalize_canonical``: within 1e-6 (its uint8 stages are exact, the
  final min-max is one f32 division).
Layouts: the port's spatial losses take NCHW, the JAX package's NHWC.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.data.preprocess import normalize_canonical as jax_normalize
from segtpu.data.preprocess import scale_canonical as jax_scale
from segtpu.losses import available_losses as jax_available_losses
from segtpu.losses import get_loss_function as jax_get_loss
from segtpu.losses.multiclass import calculate_metrics_multiclass as jax_mc_m
from segtpu.losses.multiclass import get_multiclass_loss as jax_mc_loss
from segtpu.metrics import calculate_metrics as jax_metrics
from segtpu.metrics import iou_score as jax_iou_score
from segtpu.metrics import post_process as jax_post_process
from segtpu.metrics import sweep_thresholds as jax_sweep
from segtpu.ops.clahe import clahe as jax_clahe
from segtpu.ops.edt import distance_transform_edt as jax_edt
from segtpu_torch.data.preprocess import (normalize_canonical,
                                          normalize_microscopy_image,
                                          scale_canonical)
from segtpu_torch.losses import (LOSS_FUNCTION_GUIDE, available_losses,
                                 get_loss_function)
from segtpu_torch.losses.multiclass import (calculate_metrics_multiclass,
                                            get_multiclass_loss)
from segtpu_torch.metrics import (calculate_metrics, compute_foreground_ratio,
                                  iou_score, post_process, sweep_thresholds)
from segtpu_torch.metrics.metrics import _label_fallback
from segtpu_torch.ops.clahe import clahe
from segtpu_torch.ops.edt import distance_transform_edt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host's cores: one intra-op thread
    per process keeps torch's thread pool from oversubscribing them (with
    a pool per process, these tests ran 100× slower beside the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _logits_targets(seed, shape=(2, 16, 16, 2)):
    r = np.random.default_rng(seed)
    logits = (r.normal(size=shape) * 2.0).astype(np.float32)
    targets = np.zeros(shape, np.float32)
    targets[:, 4:11, 3:12] = 1.0
    targets[0, 13:15, 1:4, 0] = 1.0
    targets[1, :, :, 1] = 0.0          # an all-background (b, c) slice
    return logits, targets


def _jax_value_grad(fn, logits, targets):
    v, g = jax.value_and_grad(lambda lg: fn(lg, jnp.asarray(targets)))(
        jnp.asarray(logits))
    return float(v), np.asarray(g)


def _port_value_grad(fn, logits, targets):
    lg = _nchw(logits).requires_grad_(True)
    v = fn(lg, _nchw(targets))
    v.backward()
    return float(v.detach()), _nhwc(lg.grad)


CONFIGS = {"default": {}, "custom": {
    "smooth": 0.5, "beta": 3.0, "focal_alpha": 0.4, "focal_gamma": 1.5,
    "loss_alpha": 0.3, "alpha_dice": 0.2, "alpha_bce": 0.5,
    "alpha_focal": 0.3, "tversky_alpha": 0.7, "tversky_beta": 0.3,
    "focal_tversky_gamma": 1.5, "sensitivity_weight": 0.3, "w_dice": 0.4,
    "w_cross": 0.6, "gamma_dice": 0.5, "gamma_cross": 0.4,
    "distance_alpha": 2.0, "hausdorff_alpha": 1.5, "boundary_theta0": 5,
    "boundary_theta": 3}}
LOSS_CASES = [(name, c) for name in jax_available_losses() + ["no_such_loss"]
              for c in CONFIGS]


@pytest.mark.parametrize("name,cfg", LOSS_CASES,
                         ids=[f"{n}-{c}" for n, c in LOSS_CASES])
def test_loss_value_and_grad_match_jax(name, cfg):
    """Every registry key (and the unknown-key fallback to combo), with
    the default and with custom hyperparameters."""
    config = {"loss_fn": name, **CONFIGS[cfg]}
    logits, targets = _logits_targets(zlib.crc32(name.encode()) % 1000)
    jfn, tfn = jax_get_loss(config), get_loss_function(config)
    assert tfn.name == jfn.name == (name if name != "no_such_loss"
                                    else "combo")
    jv, jg = _jax_value_grad(jfn, logits, targets)
    tv, tg = _port_value_grad(tfn, logits, targets)
    assert np.isfinite(tv)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())


def test_registry_lists_and_guide():
    assert available_losses() == jax_available_losses()
    for name in available_losses():
        assert f"'{name}'" in LOSS_FUNCTION_GUIDE


@pytest.mark.parametrize("name", ["ce", "dice", "combo", "focal", "other"])
def test_multiclass_loss_and_metrics_match_jax(name):
    r = np.random.default_rng(7)
    logits = r.normal(size=(2, 8, 8, 3)).astype(np.float32)
    labels = r.integers(0, 3, size=(2, 8, 8, 1)).astype(np.float32)
    config = {"loss_fn": name}
    jv, jg = _jax_value_grad(jax_mc_loss(config), logits, labels)
    tv, tg = _port_value_grad(get_multiclass_loss(config), logits, labels)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = jax_mc_m(jnp.asarray(probs), jnp.asarray(labels))
    got = calculate_metrics_multiclass(_nchw(probs), _nchw(labels))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6)


def test_edt_is_exact():
    r = np.random.default_rng(3)
    m = (r.uniform(size=(4, 33, 40)) > 0.3).astype(np.float32)
    m[1] = 1.0                 # no zero at all: scipy's corner quirk
    m[2] = 0.0
    m[3, 5:9] = 0.0
    want = np.stack([np.asarray(jax_edt(jnp.asarray(x))) for x in m])
    got = distance_transform_edt(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    from scipy.ndimage import distance_transform_edt as scipy_edt
    np.testing.assert_allclose(got[3], scipy_edt(m[3]), atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (256, 128), (128, 96),
                                   (37, 53)])
def test_clahe_is_bit_exact(shape):
    """Against the JAX op run op by op, at every size. Where the tiles'
    sides are powers of two (the canonical 128², 256², 512²) the blend's
    weights are exact, and the port also equals the jitted op and cv2;
    elsewhere XLA's fused (FMA-contracted) blend and cv2's own arithmetic
    round a few pixels otherwise, so those two are left out there."""
    r = np.random.default_rng(sum(shape))
    img = (r.uniform(0, 1, shape) ** 2 * 255).astype(np.uint8)
    got = clahe(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_clahe(jnp.asarray(img))))
    tile = (shape[0] // 8, shape[1] // 8)
    if all(shape[i] % 8 == 0 and tile[i] & (tile[i] - 1) == 0
           for i in (0, 1)):
        np.testing.assert_array_equal(
            got, np.asarray(jax.jit(jax_clahe)(jnp.asarray(img))))
        cv2 = pytest.importorskip("cv2")
        want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(img)
        np.testing.assert_array_equal(got, want)


def test_normalize_canonical_matches_jax():
    r = np.random.default_rng(11)
    imgs = (r.uniform(0, 1, (4, 64, 64)) ** 2 * 255).astype(np.uint8)
    imgs[0] = r.integers(0, 3, (64, 64))      # near-constant image
    imgs[1, :32] = 255
    want = np.asarray(jax_normalize(jnp.asarray(imgs)))
    got = normalize_canonical(torch.from_numpy(imgs))
    assert got.shape == (4, 1, 64, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6)
    one = normalize_microscopy_image(torch.from_numpy(imgs[2]))
    np.testing.assert_allclose(one.numpy(), want[2, ..., 0], atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(scale_canonical(torch.from_numpy(imgs))),
        np.asarray(jax_scale(jnp.asarray(imgs))), atol=1e-7)


def test_calculate_metrics_and_iou_score_match_jax():
    r = np.random.default_rng(5)
    probs = r.uniform(size=(3, 16, 16, 1)).astype(np.float32)
    masks = (r.uniform(size=(3, 16, 16, 1)) > 0.6).astype(np.float32)
    want = jax_metrics(jnp.asarray(probs), jnp.asarray(masks))
    got = calculate_metrics(_nchw(probs), _nchw(masks))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6)
    logits = r.normal(size=(16, 16)).astype(np.float32)
    blobs = np.zeros((16, 16), np.float32)
    blobs[2:9, 3:12] = 1.0
    for pp in (False, True):
        assert iou_score(torch.from_numpy(logits), blobs, pp, 5) == \
            jax_iou_score(logits, blobs, pp, 5)
    assert compute_foreground_ratio([blobs]) == pytest.approx(blobs.mean())


def test_post_process_matches_jax_and_scipy_free_labels():
    r = np.random.default_rng(9)
    pred = (r.uniform(size=(40, 40)) > 0.55).astype(np.float32)
    pred[5:15, 5:15] = 1.0
    np.testing.assert_array_equal(post_process(pred, 15),
                                  jax_post_process(pred, 15))
    from scipy import ndimage
    want, n = ndimage.label(pred > 0.5)
    got, m, sizes = _label_fallback((pred > 0.5).astype(np.uint8))
    assert m == n
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sizes, np.bincount(want.ravel())[1:])


@pytest.mark.parametrize("metric", ["iou", "f1"])
def test_sweep_thresholds_matches_jax(metric):
    r = np.random.default_rng(13)
    probs = r.uniform(size=(2, 24, 24, 1)).astype(np.float32)
    masks = (r.uniform(size=(2, 24, 24, 1)) > 0.7).astype(np.float32)
    want = jax_sweep(probs, masks, metric=metric)
    got = sweep_thresholds(torch.from_numpy(probs), masks, metric=metric)
    for k in ("thresholds", "precision", "recall", "f1", "iou", "accuracy"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("best_threshold", "best_value", "metric"):
        assert got[k] == want[k]
    at_half = calculate_metrics(torch.from_numpy(probs),
                                torch.from_numpy(masks))["iou"]
    np.testing.assert_allclose(got["iou"][9], float(at_half), atol=1e-6)
