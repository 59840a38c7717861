"""The port's augmentation (segtpu_torch.data.augment) against the JAX
package's (segtpu.data.augment), on the CPU.

A transform's draws and its apply are separate in the port, so the apply
is held against the JAX transform given the same draws: the test replaces
``jax.random``'s draw functions by a feed of the port's parameters, in the
order the JAX transform calls them, and runs it eagerly image by image.
The random streams themselves cannot match (JAX's PRNG is not torch's);
the draws are held by their statistics, as tests/test_augment_stats.py
holds the JAX package's.

Tolerances, and why:
- index folding, exact; the samplers and the 7×7 reflect convolution at
  fixed coordinates and kernels within 1e-5 of the image's largest value
  (float32: the same taps and weights, summed in another order); nearest
  samples exact;
- a transform's apply given the same draws: images within 1e-3 on the
  0–255 scale (the coordinates go through sin, cos, tan, exp and pow,
  whose float32 results may differ by an ulp between XLA and torch, and
  a bilinear sample moves by at most 255 per pixel of coordinate);
  masks equal at all but 0.1% of pixels (a coordinate an ulp from a
  half-pixel can round to the other neighbour);
- gate rates within 0.1 of p over 400 draws (4.5 standard deviations at
  p = 0.5), parameters inside their ranges.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.data import augment as JA
from segtpu_torch.data import augment as A

S = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, n=2, s=S):
    """Smooth-ish images in [0, 255] and binary masks of blobs."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s]
    img = r.uniform(0, 60, (n, s, s)) + 40 * np.sin(yy / 5.0 + r.uniform(
        0, 6, (n, 1, 1))) ** 2
    mask = np.zeros((n, s, s), np.float32)
    for i in range(n):
        cy, cx = r.integers(s // 4, s - s // 4, 2)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 80
        img[i][blob] += 120
        mask[i][blob] = 1.0
    return np.clip(img, 0, 255).astype(np.float32), mask


# -------------------------------------------------------------- samplers

def test_reflect101_folding_matches_jax():
    n = 7
    i = np.arange(-30, 31)
    c = np.linspace(-25.3, 31.7, 97).astype(np.float32)
    np.testing.assert_array_equal(
        A._reflect101_idx(torch.from_numpy(i), n).numpy(),
        np.asarray(JA._reflect101_idx(jnp.asarray(i), n)))
    np.testing.assert_array_equal(
        A._reflect101_coord(torch.from_numpy(c), n).numpy(),
        np.asarray(JA._reflect101_coord(jnp.asarray(c), n)))
    assert A._reflect101_idx(torch.tensor([5, -3]), 1).tolist() == [0, 0]


@pytest.mark.parametrize("border", ["reflect", "constant"])
def test_samplers_match_jax(border):
    """Coordinates inside, on and beyond the grid, including exact
    integers and half-pixels."""
    img, mask = _frames(1, n=2, s=24)
    r = np.random.default_rng(2)
    ys = r.uniform(-6, 30, (2, 20, 16)).astype(np.float32)
    xs = r.uniform(-6, 30, (2, 20, 16)).astype(np.float32)
    ys[:, 0] = np.arange(16) - 1.5            # integers and half-pixels
    xs[:, 1] = np.arange(16) + 0.5
    ti, tm = torch.from_numpy(img), torch.from_numpy(mask)
    tys, txs = torch.from_numpy(ys), torch.from_numpy(xs)
    got_b = A.sample_bilinear(ti, tys, txs, border).numpy()
    got_n = A.sample_nearest(tm, tys, txs, border).numpy()
    for k in range(2):
        want_b = np.asarray(JA.sample_bilinear(jnp.asarray(img[k]),
                                               jnp.asarray(ys[k]),
                                               jnp.asarray(xs[k]), border))
        want_n = np.asarray(JA.sample_nearest(jnp.asarray(mask[k]),
                                              jnp.asarray(ys[k]),
                                              jnp.asarray(xs[k]), border))
        np.testing.assert_allclose(got_b[k], want_b, rtol=0,
                                   atol=1e-5 * img.max())
        np.testing.assert_array_equal(got_n[k], want_n)
    with pytest.raises(ValueError, match="border"):
        A.sample_bilinear(ti, tys, txs, "wrap")


def test_conv2_same_reflect_matches_jax():
    img, _ = _frames(3, n=2, s=20)
    r = np.random.default_rng(4)
    kern = r.uniform(-1, 1, (2, 7, 7)).astype(np.float32)
    got = A._conv2_same_reflect(torch.from_numpy(img),
                                torch.from_numpy(kern)).numpy()
    for k in range(2):
        want = np.asarray(JA._conv2_same_reflect(jnp.asarray(img[k]),
                                                 jnp.asarray(kern[k])))
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ------------------------------------ apply against JAX, same draws

class _Feed:
    """Stands in for jax.random's draw functions: each call returns the
    next queued value, broadcast to the shape asked for."""

    def __init__(self, values):
        self.values = list(values)

    def _next(self, shape, dtype):
        v = np.asarray(self.values.pop(0))
        return jnp.asarray(np.broadcast_to(v, tuple(shape or ())), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return self._next(shape, dtype)

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return self._next(shape, dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return self._next(shape, dtype)

    def bernoulli(self, key, p=0.5, shape=None):
        return self._next(shape, jnp.bool_)


def _jax_draws(name, p, i, s):
    """Image i's draws, in the order the JAX transform makes them."""
    v = {k: t[i].numpy() for k, t in p.items()}
    if name == "random_rotate_90":
        return [v["k"]]
    if name == "affine":
        return [v[k] for k in ("sx", "sy", "tx", "ty", "rotate", "shear")]
    if name == "grid_distortion":
        return [v["dx"], v["dy"]]
    if name in ("optical_distortion",):
        return [v["k"], v["dx"], v["dy"]]
    if name == "gauss_noise":
        return [v["var"], v["noise"]]
    if name == "random_gamma":
        return [v["gamma"]]
    if name == "color_jitter":
        return [v["b"], v["c"], v["brightness_first"]]
    if name == "advanced_blur":
        return [(v["ksize"] - 3) // 2, v["sx"], v["sy"], v["rotate"], True,
                v["beta"], v["beta"], v["noise"]]
    if name == "downscale":
        return [v["sc"]]
    if name == "coarse_dropout":
        holes = [[v[k][j] for k in ("h", "w", "y0", "x0")]
                 for j in range(len(v["h"]))]
        return [v["n_holes"], *[x for hole in holes for x in hole]]
    if name == "grid_dropout":
        return [v["unit"], v["oy"], v["ox"]]
    if name == "random_crop":
        return [v["oy"], v["ox"]]
    if name == "random_crop_raw":      # the uniforms behind the offsets
        return [np.float32(v["oy"] / (s - v["cy"])),
                np.float32(v["ox"] / (s - v["cx"]))]
    if name == "crop_and_pad":
        return list(v["sides"])
    return []


CASES = sorted(A.AUGMENTATION_CANDIDATES) + [
    "affine_constant", "random_crop_32", "random_crop_raw", "downscale_raw"]


def _transforms(case):
    if case == "affine_constant":                 # the production affine
        return A.t_affine, JA.t_affine, "affine"
    if case == "random_crop_32":   # a crop inside the frame (96 ≥ S is all)
        return (A.RandomCrop(32), functools.partial(JA.t_random_crop,
                                                    crop=32), "random_crop")
    base = case.removesuffix("_raw")
    return (A.AUGMENTATION_CANDIDATES[base], JA.AUGMENTATION_CANDIDATES[base],
            base)


@pytest.mark.parametrize("case", CASES)
def test_apply_matches_jax_given_the_same_draws(case, monkeypatch):
    port, ref, name = _transforms(case)
    img, mask = _frames(5)
    raw = np.array([[97, 131], [300, 200]]) if case.endswith("_raw") \
        else None
    gen = torch.Generator().manual_seed(CASES.index(case))
    params = port.draw(gen, 2, S, None if raw is None
                       else torch.from_numpy(raw))
    gi, gm = port.apply(torch.from_numpy(img), torch.from_numpy(mask * 255),
                        params)
    key = "random_crop_raw" if case == "random_crop_raw" else name
    # the draws move what they should (a 96² crop of a 48² frame is all)
    moved = not torch.equal(gm, torch.from_numpy(mask * 255))
    assert moved == (port.moves_mask and case != "random_crop"), case
    for i in range(2):
        feed = _Feed(_jax_draws(key, params, i, S))
        for fn in ("uniform", "randint", "normal", "bernoulli"):
            monkeypatch.setattr(jax.random, fn, getattr(feed, fn))
        kw = {} if raw is None else {"raw_hw": raw[i]}
        wi, wm = ref((jnp.asarray(img[i]), jnp.asarray(mask[i] * 255)),
                     jax.random.key(0), **kw)
        monkeypatch.undo()
        assert feed.values == [], f"{case}: draws left over"
        np.testing.assert_allclose(gi[i].numpy(), np.asarray(wi), rtol=0,
                                   atol=1e-3)
        differ = float((gm[i].numpy() != np.asarray(wm)).mean())
        assert differ <= 1e-3, f"{case}: {differ:.2%} of mask pixels differ"


GEOMETRIC = ["affine", "affine_constant", "grid_distortion",
             "optical_distortion", "random_crop", "random_crop_raw",
             "crop_and_pad", "downscale", "downscale_raw"]


@pytest.mark.parametrize("case", GEOMETRIC)
def test_apply_matches_jax_samplers_at_the_ports_coordinates(case):
    """The port's warp against the JAX package's samplers fed the port's
    own coordinates (``coords``): the sampling alone, exact up to the
    order of sums."""
    port, _, _ = _transforms(case)
    img, mask = _frames(6)
    raw = torch.tensor([[97, 131], [300, 200]]) if case.endswith("_raw") \
        else None
    params = port.draw(torch.Generator().manual_seed(7), 2, S, raw)
    ys, xs = port.coords(params, S)
    gi, gm = port.apply(torch.from_numpy(img), torch.from_numpy(mask),
                        params)
    border = getattr(port, "border", "reflect")
    for i in range(2):
        y, x = jnp.asarray(ys[i].numpy()), jnp.asarray(xs[i].numpy())
        wi = JA.sample_bilinear(jnp.asarray(img[i]), y, x, border)
        np.testing.assert_allclose(gi[i].numpy(), np.asarray(wi), rtol=0,
                                   atol=1e-5 * 255)
        if case.startswith("downscale"):            # image only
            np.testing.assert_array_equal(gm[i].numpy(), mask[i])
        else:
            wm = JA.sample_nearest(jnp.asarray(mask[i]), y, x, border)
            np.testing.assert_array_equal(gm[i].numpy(), np.asarray(wm))


def test_u8_contract_matches_jax_batch_fn():
    """A deterministic pipeline through both packages' uint8 entry: the
    same rounding of images, binary thresholding and label rounding."""
    img, mask = _frames(8, n=3)
    u8 = np.floor(img).astype(np.uint8)
    m8 = mask.astype(np.uint8)
    steps = [(A.t_invert, 1.0), (A.t_random_gamma, 1.0)]
    port = A.Pipeline(steps)
    gen = torch.Generator().manual_seed(0)
    draws = port.draw(gen, 3, S)
    for label in (False, True):
        labels = m8 * (2 if label else 1)
        got_i, got_m = A.Pipeline([(A.t_invert, 1.0)]).augment_u8(
            torch.from_numpy(u8), torch.from_numpy(labels),
            torch.Generator(), label_mask=label)
        fn = JA.Pipeline([(JA.t_invert, 1.0)]).batch_fn(label_mask=label)
        want_i, want_m = fn(jnp.asarray(u8), jnp.asarray(labels),
                            jax.random.split(jax.random.key(0), 3))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # a gated chain: applied where the gate is open, image by image
    out_i, _ = port.apply(torch.from_numpy(img), torch.from_numpy(mask),
                          draws)
    g = draws[1][1]["gamma"].numpy()[:, None, None] / 100.0
    want = np.power(np.clip((255.0 - img) / 255.0, 1e-7, 1.0), g) * 255.0
    np.testing.assert_allclose(out_i.numpy(), want, rtol=1e-5, atol=1e-3)


# -------------------------------------------------------------- draws

def test_gates_open_at_their_probability():
    n = 400
    pipe = A.build_pipeline(["invert", "vertical_flip"], for_selection=True)
    prod = A._production_pipeline()
    assert [p for _, p, _ in prod.steps] == [0.5, 0.3, 0.5, 0.3]
    assert [type(t).__name__ for t, _, _ in prod.steps] == [
        "RandomRotate90", "Affine", "VerticalFlip", "AdvancedBlur"]
    assert prod.steps[1][0].border == "constant"
    gen = torch.Generator().manual_seed(1)
    for pipeline, ps in ((pipe, [0.7, 0.7]), (prod, [0.5, 0.3, 0.5, 0.3])):
        draws = pipeline.draw(gen, n, 16)
        for (gate, _), p in zip(draws, ps):
            assert abs(float(gate.float().mean()) - p) < 0.1
    prod_sel = A.build_pipeline(["horizontal_flip", "affine", "transpose"],
                                for_selection=False)
    assert [p for _, p, _ in prod_sel.steps] == [0.5, 0.3, 0.3]
    assert A.production_probability("clahe") == 0.7
    raw_aware = A.build_pipeline(["random_crop", "downscale", "invert"])
    assert [r for _, _, r in raw_aware.steps] == [True, True, False]


def test_draws_stay_in_their_ranges():
    n, s = 500, 64
    gen = torch.Generator().manual_seed(2)
    d = lambda name, raw=None: A.AUGMENTATION_CANDIDATES[name].draw(
        gen, n, s, raw)

    def within(t, lo, hi):
        return bool(((t >= lo) & (t <= hi)).all())

    p = d("affine")
    assert within(p["sx"], 0.95, 1.05) and within(p["sy"], 0.95, 1.05)
    assert within(p["tx"], -0.05, 0.05) and within(p["rotate"], -15, 15)
    assert within(p["shear"], -5, 5)
    k = d("random_rotate_90")["k"]
    assert set(torch.bincount(k, minlength=4).tolist()) and all(
        60 < c < 190 for c in torch.bincount(k, minlength=4).tolist())
    b = d("advanced_blur")
    assert set(b["ksize"].unique().tolist()) == {3, 5, 7}
    assert within(b["beta"], 0.5, 8.0) and within(b["noise"], 0.9, 1.1)
    assert 0.35 < float((b["beta"] < 1).float().mean()) < 0.65
    assert within(d("grid_distortion")["dx"], -0.3, 0.3)
    assert within(d("gauss_noise")["var"], 10, 50)
    assert within(d("random_gamma")["gamma"], 80, 120)
    c = d("coarse_dropout")
    assert within(c["n_holes"], 4, 8) and within(c["h"], 4, 8)
    assert within(c["y0"], 0, s - 4)
    g = d("grid_dropout")
    assert within(g["unit"], 4, 8) and within(g["oy"], 0, 7)
    crop = d("random_crop")
    assert within(crop["oy"], 0, 0) and bool((crop["cy"] == 64).all())
    raw = torch.tensor([[1024, 1360]] * n)
    crop = d("random_crop", raw)
    assert torch.allclose(crop["cy"], torch.tensor(96 * 64 / 1024))
    assert within(crop["oy"], 0, s - float(crop["cy"][0]))
    ds = d("downscale", raw)
    assert within(ds["sc"], 0.5, 0.75) and bool((ds["hw"] == raw).all())


def test_masks_stay_binary_and_move_with_the_image():
    """Every candidate keeps masks binary through the uint8 entry; the
    relayouts move the mask exactly as the image (an image that is the
    mask × 255 comes out as the mask × 255); intensity, blur and dropout
    transforms leave the mask alone."""
    _, mask = _frames(9, n=4)
    m8 = torch.from_numpy(mask.astype(np.uint8))
    gen = torch.Generator().manual_seed(3)
    for name, t in A.AUGMENTATION_CANDIDATES.items():
        ai, am = A.augment_batch(m8 * 255, m8, gen, t, copies=2)
        assert ai.shape == am.shape == (8, S, S)
        assert set(am.unique().tolist()) <= {0, 1}, name
        if name in ("horizontal_flip", "vertical_flip", "transpose",
                    "random_rotate_90"):
            assert torch.equal(ai, am * 255), name
        if not t.moves_mask:
            assert torch.equal(am, m8.repeat(2, 1, 1)), name
    assert {n for n, t in A.AUGMENTATION_CANDIDATES.items()
            if t.moves_mask} == {
        "horizontal_flip", "affine", "random_rotate_90", "transpose",
        "grid_distortion", "vertical_flip", "optical_distortion",
        "random_crop", "crop_and_pad"}


def test_cell_augmenter_keeps_originals_first_and_counts():
    img, mask = _frames(10, n=3)
    u8, m8 = np.floor(img).astype(np.uint8), mask.astype(np.uint8)
    aug = A.CellAugmenter(augmentations_per_image=3, seed=4, device="cpu")
    ai, am = aug.augment_training_data(u8, m8)
    assert ai.shape == am.shape == (12, S, S) and ai.dtype == torch.uint8
    assert torch.equal(ai[:3], torch.from_numpy(u8))
    assert torch.equal(am[:3], torch.from_numpy(m8))
    assert set(am.unique().tolist()) <= {0, 1}
    again = A.CellAugmenter(3, seed=4, device="cpu").augment_training_data(
        u8, m8)
    assert torch.equal(again[0], ai) and torch.equal(again[1], am)
    other = A.CellAugmenter(3, seed=5, device="cpu").augment_training_data(
        u8, m8)
    assert not torch.equal(other[0], ai)
    with A.CellAugmenter(0, device="cpu") as none:
        same = none.augment_training_data(u8, m8)
    assert torch.equal(same[0], torch.from_numpy(u8))
    labels = A.CellAugmenter(2, n_classes=3, device="cpu")
    _, lm = labels.augment_training_data(u8, m8 * 2)
    assert set(lm.unique().tolist()) <= {0, 2}


def test_augment_batch_raw_shapes_need_a_pipeline():
    img, mask = _frames(11, n=2)
    u8, m8 = torch.from_numpy(img.astype(np.uint8)), torch.from_numpy(
        mask.astype(np.uint8))
    gen = torch.Generator()
    with pytest.raises(ValueError, match="raw_hw requires a Pipeline"):
        A.augment_batch(u8, m8, gen, A.t_random_crop, 1,
                        raw_hw=[[96, 96]] * 2)
    with pytest.raises(ValueError, match="label_mask"):
        A.build_pipeline(["random_crop"]).augment_u8(
            u8, m8, gen, raw_hw=[[96, 96]] * 2, label_mask=True)
    ai, _ = A.augment_batch(u8, m8, gen, A.build_pipeline(["random_crop"]),
                            2, raw_hw=np.array([[96, 96], [1024, 1024]]))
    assert ai.shape == (4, S, S)
    same, _ = A.augment_batch(u8, m8, gen, None, 1)
    assert torch.equal(same, u8)
