"""The port's data layer (segtpu_torch.data: discovery, TIFF IO, resize,
canonical frames, dataset and loader) and its consumers (``train_model``,
``Segmenter``, ``compute_foreground_ratio`` on paths) against the JAX
package's, on the same files, on the CPU.

Tolerances, and why:
- discovery, decode, nearest resize, canonical masks, raw shapes:
  exact;
- ``resize_area`` in float32 within 1e-4 of JAX's on the 0–255 scale
  (both sum the same products of float32 weights, in another order;
  a few ulps of 255); after the round to uint8, within one level at no
  more than 0.1% of pixels (a sum an ulp either side of a half);
- normalised inputs from the same canonical frames within 1e-6
  (percentiles and CLAHE bit-exact, then one float32 division);
- ``Segmenter.fit`` on paths from the same initial weights:
  tests/test_torch_train.py's ``train_model`` bars, epoch losses rtol
  1e-4 and IoUs atol 1e-2.
"""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from PIL import Image

from segtpu.api import Segmenter as JaxSegmenter
from segtpu.data import discovery as jdisc
from segtpu.data import io as jio
from segtpu.data import loader as jloader
from segtpu.data import preprocess as jpre
from segtpu.metrics.metrics import compute_foreground_ratio as jax_ratio
from segtpu.ops import resize as jresize
from segtpu_torch.api import Segmenter
from segtpu_torch.data import discovery, io, loader, native, preprocess
from segtpu_torch.metrics.metrics import compute_foreground_ratio
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.ops import resize
from segtpu_torch.train import loop

ROOT = Path(__file__).resolve().parent.parent
S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """6 W pairs at a raw 96×128 (``make_synthetic_dataset``), 3 W pairs
    at 80×72 under other names, 2 B pairs, a mask that is not ``*GT.tif``
    and an image without a mask."""
    root = str(tmp_path_factory.mktemp("cells"))
    io.make_synthetic_dataset(root, n_images=6, raw_size=(96, 128), seed=1)
    io.make_synthetic_dataset(root, n_images=2, image_type="B",
                              raw_size=(40, 40), seed=2)
    r = np.random.default_rng(3)
    imgs, masks = (os.path.join(root, d) for d in ("Labelled_images",
                                                   "GT_masks"))
    for i in range(3):
        stem = f"Other_C_D_2W_{i:02d}"
        m = np.zeros((80, 72), np.uint8)
        m[10 + 5 * i:40, 20:50 + i] = 255
        io.write_tiff(os.path.join(imgs, f"{stem}.tif"),
                      r.integers(0, 256, (80, 72), np.uint8))
        io.write_tiff(os.path.join(masks, f"{stem}_GT.tif"), m)
    io.write_tiff(os.path.join(masks, "Img_A_B_1W_000_notes.tif"),
                  np.zeros((4, 4), np.uint8))
    io.write_tiff(os.path.join(imgs, "Img_A_B_1W_099.tif"),
                  np.zeros((4, 4), np.uint8))
    return root


# ------------------------------------------------------------- discovery

@pytest.mark.parametrize("image_type", ["W", "B"])
def test_discovery_matches_jax(data_dir, image_type):
    got = discovery.load_original_data(data_dir, image_type,
                                       with_groups=True)
    want = jdisc.load_original_data(data_dir, image_type, with_groups=True)
    assert got == want
    assert len(got["image_paths"]) == (9 if image_type == "W" else 2)
    assert discovery.load_original_data(data_dir, image_type) == {
        k: v for k, v in want.items() if k != "base_names"}


def test_discovery_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        discovery.load_original_data(str(tmp_path / "none"))


# ------------------------------------------------------------- TIFF IO

@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (96, 128)])
def test_write_tiff_reads_back_everywhere(tmp_path, shape):
    """The port's numpy-only TIFF: Pillow, ``segtpu``'s decode and the
    port's decode read back the array written."""
    a = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    p = str(tmp_path / "a.tif")
    assert io.write_tiff(p, a)
    with Image.open(p) as im:
        assert im.mode == "L" and im.size == shape[::-1]
        np.testing.assert_array_equal(np.asarray(im), a)
    jio.clear_decode_cache()
    np.testing.assert_array_equal(jio.decode_gray(p), a)
    np.testing.assert_array_equal(io.decode_gray(p), a)
    with pytest.raises(ValueError, match="2-D"):
        io.write_tiff(p, np.zeros((2, 2, 3), np.uint8))


def test_synthetic_dataset_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    io.make_synthetic_dataset(a, n_images=3, raw_size=(40, 56), seed=4)
    jio.make_synthetic_dataset(b, n_images=3, raw_size=(40, 56), seed=4)
    for sub in ("Labelled_images", "GT_masks"):
        names = sorted(os.listdir(os.path.join(a, sub)))
        assert names == sorted(os.listdir(os.path.join(b, sub)))
        for name in names:
            with Image.open(os.path.join(a, sub, name)) as x, \
                    Image.open(os.path.join(b, sub, name)) as y:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _pil_file(path, variant, rng):
    """(path, array) of a TIFF that Pillow writes in ``variant``."""
    smooth = (np.cumsum(rng.integers(-2, 3, (45, 70)), axis=1) % 256)
    if variant == "u16":
        a = rng.integers(0, 65536, (45, 70)).astype(np.uint16)
        Image.fromarray(a).save(path)
    elif variant == "u16_lzw_predictor":
        a = (smooth * 257).astype(np.uint16)
        Image.fromarray(a).save(path, compression="tiff_lzw",
                                tiffinfo={317: 2})
    else:
        a = smooth.astype(np.uint8)
        kw = {"u8": {},
              "lzw_predictor": dict(compression="tiff_lzw",
                                    tiffinfo={317: 2}),
              "packbits": dict(compression="packbits")}[variant]
        Image.fromarray(a).save(path, **kw)
    return path, a


@pytest.mark.parametrize("variant", ["u8", "u16", "lzw_predictor",
                                     "u16_lzw_predictor", "packbits"])
def test_decode_matches_jax_bit_exact(tmp_path, variant):
    """8- and 16-bit (/256, unconditionally), LZW with the horizontal
    predictor and PackBits, all decoded by the port's native reader."""
    p, a = _pil_file(str(tmp_path / f"{variant}.tif"), variant,
                     np.random.default_rng(5))
    io.clear_decode_cache()
    jio.clear_decode_cache()
    before = io.decode_counts()
    got = io.decode_gray(p)
    np.testing.assert_array_equal(got, jio.decode_gray(p))
    want = (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a
    np.testing.assert_array_equal(got, want)
    after = io.decode_counts()
    assert after["native"] == before["native"] + 1
    assert after["pil"] == before["pil"]
    assert io.decode_gray(p) is got               # cached: no decode
    assert io.decode_counts() == after


def test_batch_decode_sends_only_refused_files_to_pillow(tmp_path):
    rng = np.random.default_rng(6)
    files = [_pil_file(str(tmp_path / f"{v}.tif"), v, rng)
             for v in ("u8", "packbits", "u16")]
    rgb = str(tmp_path / "rgb.tif")
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8)).save(rgb)
    paths = [p for p, _ in files] + [rgb]
    io.clear_decode_cache()
    jio.clear_decode_cache()
    io.reset_decode_counts()
    got = io.decode_gray_batch(paths, n_threads=2)
    assert io.decode_counts() == {"native": 3, "pil": 1}
    for g, w in zip(got, jio.decode_gray_batch(paths)):
        np.testing.assert_array_equal(g, w)
    assert native.native_decode_gray(rgb) is None
    again = io.decode_gray_batch(paths)
    assert all(a is b for a, b in zip(again, got))
    assert io.decode_counts() == {"native": 3, "pil": 1}


def test_refused_file_without_pillow_raises_naming_it(tmp_path,
                                                      monkeypatch):
    rgb = str(tmp_path / "rgb.tif")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(rgb)
    io.clear_decode_cache()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="rgb.tif.*Pillow"):
        io.decode_gray(rgb)


def test_reader_builds_under_build_and_a_failed_build_raises(tmp_path,
                                                             monkeypatch):
    assert native.LIBRARY == ROOT / "build" / "segtpu_torch" / \
        "libsegtpu_io.so"
    native.build()
    assert native.LIBRARY.is_file()
    broken = tmp_path / "segtpu_io.cc"
    broken.write_text(native.SOURCE.read_text() + "\n#error broken copy\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "out" / "lib.so")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="broken copy"):
        native.native_decode_gray(str(broken))


# ---------------------------------------------------------------- resize

RESIZES = [((96, 128), (32, 32)), ((20, 24), (64, 64)),
           ((40, 20), (32, 32)), ((97, 131), (64, 64)),
           ((64, 64), (64, 64))]


@pytest.mark.parametrize("raw,out", RESIZES,
                         ids=["down", "up", "mixed", "ragged", "same"])
def test_resize_matches_jax(raw, out):
    r = np.random.default_rng(raw[0])
    imgs = r.integers(0, 256, (3, *raw), np.uint8)
    masks = (r.random((3, *raw)) > 0.5).astype(np.uint8)
    got = resize.resize_area(torch.from_numpy(imgs), out).numpy()
    want = np.stack([np.asarray(jresize.resize_area(jax.numpy.asarray(a),
                                                    out)) for a in imgs])
    assert got.dtype == np.float32 and got.shape == (3, *out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got8 = preprocess._round_u8(torch.from_numpy(got)).numpy()
    want8 = np.floor(np.clip(want, 0, 255) + 0.5).astype(np.uint8)
    diff = np.abs(got8.astype(int) - want8)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    got_m = resize.resize_nearest(torch.from_numpy(masks), out)
    assert got_m.dtype == torch.uint8
    np.testing.assert_array_equal(got_m.numpy(), np.stack([
        np.asarray(jresize.resize_nearest(jax.numpy.asarray(m), out))
        for m in masks]))


# ------------------------------------------------------ canonical frames

def _w_paths(data_dir):
    d = discovery.load_original_data(data_dir, "W")
    return d["image_paths"], d["mask_paths"]


def test_load_canonical_matches_jax(data_dir):
    """Two raw shapes, in chunks of 4 and in one batch, with the raw
    shapes; the images-only loader gives the pair loader's images."""
    ip, mp = _w_paths(data_dir)
    io.clear_decode_cache()
    io.reset_decode_counts()
    ci, cm, rs = preprocess.load_canonical(ip, mp, (S, S),
                                           return_raw_shapes=True, chunk=4,
                                           device="cpu")
    assert io.decode_counts() == {"native": 18, "pil": 0}
    wi, wm, ws = jpre.load_canonical(ip, mp, (S, S), return_raw_shapes=True)
    assert ci.dtype == cm.dtype == np.uint8 and ci.shape == (9, S, S)
    np.testing.assert_array_equal(cm, wm)
    np.testing.assert_array_equal(rs, ws)
    assert sorted({tuple(x) for x in rs}) == [(80, 72), (96, 128)]
    diff = np.abs(ci.astype(int) - wi)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    one_i, one_m = preprocess.load_canonical(ip, mp, (S, S), chunk=None,
                                             device="cpu")
    np.testing.assert_array_equal(one_i, ci)
    np.testing.assert_array_equal(one_m, cm)
    np.testing.assert_array_equal(
        preprocess.load_canonical_images(ip, (S, S), chunk=3, device="cpu"),
        ci)
    assert preprocess.load_canonical([], [], (S, S), device="cpu")[0].shape \
        == (0, S, S)
    with pytest.raises(ValueError, match="counts differ"):
        preprocess.load_canonical(ip, mp[:-1], (S, S), device="cpu")


def test_load_canonical_mask_at_another_raw_shape_matches_jax(tmp_path):
    """A mask not at its image's raw shape is brought to it by nearest
    resizing before the canonical resize, as in JAX."""
    r = np.random.default_rng(4)
    ip, mp = [], []
    for i, (img_hw, msk_hw) in enumerate((((96, 128), (41, 57)),
                                          ((70, 90), (83, 61)))):
        m = (r.random(msk_hw) > 0.5).astype(np.uint8) * 255
        ip.append(str(tmp_path / f"img{i}.tif"))
        mp.append(str(tmp_path / f"img{i}_GT.tif"))
        io.write_tiff(ip[-1], r.integers(0, 256, img_hw, np.uint8))
        io.write_tiff(mp[-1], m)
    io.clear_decode_cache()
    ci, cm, rs = preprocess.load_canonical(ip, mp, (S, S),
                                           return_raw_shapes=True,
                                           device="cpu")
    wi, wm, ws = jpre.load_canonical(ip, mp, (S, S), return_raw_shapes=True)
    np.testing.assert_array_equal(cm, wm)
    np.testing.assert_array_equal(rs, ws)
    assert cm.any() and (cm == 0).any()
    diff = np.abs(ci.astype(int) - wi)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_failed_resize_unblocks_the_decode_thread(data_dir, monkeypatch):
    """A resize that raises mid-stream: the producer thread (perhaps
    blocked on the full queue) is drained and gone before the error
    reaches the caller."""
    ip, _ = _w_paths(data_dir)

    def boom(*a):
        raise RuntimeError("injected resize failure")

    monkeypatch.setattr(preprocess, "resize_area", boom)
    io.clear_decode_cache()
    with pytest.raises(RuntimeError, match="injected resize failure"):
        preprocess.load_canonical_images(ip, (S, S), chunk=1, device="cpu")
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "segtpu-torch-decode-prefetch"
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "segtpu-torch-decode-prefetch"
                   for t in threading.enumerate())


def test_dataset_and_prepare_data_match_jax(data_dir):
    ip, mp = _w_paths(data_dir)
    ds = loader.CellSegmentationDataset(ip, mp, img_size=(S, S),
                                        device="cpu")
    assert len(ds) == 9
    imgs, masks = ds.materialize()
    assert ds.materialize()[0] is imgs
    assert imgs.shape == masks.shape == (9, 1, S, S)
    assert imgs.dtype == masks.dtype == torch.float32
    jds = jloader.CellSegmentationDataset(ip, mp, img_size=(S, S))
    wi, wm = (np.asarray(a)[..., 0] for a in jds.materialize())
    np.testing.assert_array_equal(masks[:, 0].numpy(), wm)
    canon = preprocess.load_canonical(ip, mp, (S, S), device="cpu")
    same = loader.CellSegmentationDataset(ip, mp, (S, S), canonical=canon,
                                          device="cpu").materialize()[0]
    torch.testing.assert_close(same, imgs, rtol=0, atol=0)
    want = np.asarray(jpre.normalize_canonical(jax.numpy.asarray(
        canon[0])))[..., 0]
    np.testing.assert_allclose(imgs[:, 0].numpy(), want, rtol=0, atol=1e-6)
    raw = loader.CellSegmentationDataset(ip, mp, (S, S), normalize=False,
                                         canonical=canon, device="cpu")
    np.testing.assert_allclose(raw.materialize()[0][:, 0].numpy(),
                               canon[0] / 255.0, rtol=1e-7)
    x, y = ds[2]
    assert x.shape == y.shape == (1, S, S)
    dl = loader.prepare_data(ip, mp, batch_size=4, img_size=(S, S),
                             device="cpu")
    assert (dl.n, dl.batch_size, len(dl)) == (9, 4, 3)
    (fi, fm), rem = dl.batches(torch.Generator().manual_seed(0))
    assert fi.shape == (2, 4, 1, S, S) and rem[0].shape == (1, 1, S, S)


def test_compute_foreground_ratio_from_data_dir_matches_jax(data_dir):
    got = compute_foreground_ratio(data_dir=data_dir, image_type="W",
                                   img_size=(S, S), device="cpu")
    want = jax_ratio(data_dir=data_dir, image_type="W", img_size=(S, S))
    assert 0 < got < 1
    assert got == pytest.approx(want, rel=1e-12)


# ------------------------------------------------------------ consumers

CFG = {"img_size": (S, S), "batch_size": 8, "num_epochs": 2,
       "verbose": False, "seed": 0, "loss_fn": "combo"}


def test_segmenter_fit_on_paths_matches_jax(data_dir, monkeypatch):
    """``fit`` on 9 path pairs (7 train, the last 2 held out; one batch
    per epoch, so the shuffle order does not matter) from the JAX
    package's initial weights; then ``predict`` on paths equals
    ``predict`` on their canonical frames, and uint8 frames at another
    size are resized as the JAX package resizes them."""
    ip, mp = _w_paths(data_dir)
    jseg = JaxSegmenter(backbone="resnet_tiny", use_attention=True,
                        config=dict(CFG))
    jstate = jseg.engine.init_state(jax.random.key(0), (1, S, S, 1), 1e-3,
                                    1e-5)
    seg = Segmenter(backbone="resnet_tiny", use_attention=True,
                    config=dict(CFG), device="cpu")
    sd = state_dict_from_jax(jstate.params, jstate.batch_stats,
                             "resnet_tiny", True, device="cpu")
    monkeypatch.setattr(seg.engine, "init_state",
                        lambda gen, lr, wd: seg.engine.state_from(sd, lr,
                                                                  wd))
    jseg.fit(ip, mp)
    seg.fit(ip, mp)
    for key in ("train_metrics", "val_metrics"):
        assert len(seg.history[key]) == len(jseg.history[key]) == 2
        for g, w in zip(seg.history[key], jseg.history[key]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            for k in ("iou", "f1", "precision", "recall", "accuracy"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-2)
    canon = preprocess.load_canonical_images(ip, (S, S), device="cpu")
    np.testing.assert_array_equal(seg.predict(ip), seg.predict(canon))
    np.testing.assert_allclose(seg._prep_images(ip),
                               np.asarray(jseg._prep_images(ip)), rtol=0,
                               atol=1e-6)
    raw = np.random.default_rng(7).integers(0, 256, (2, 48, 40), np.uint8)
    np.testing.assert_allclose(seg._prep_images(raw),
                               np.asarray(jseg._prep_images(raw)), rtol=0,
                               atol=1e-6)
    metrics = seg.evaluate(ip[:4], mp[:4])
    assert all(np.isfinite(v) for v in metrics.values())


def test_fit_with_augmentation_trains_on_three_times_the_images(
        data_dir, monkeypatch):
    """``augmentations_per_image=2``: the training loader holds the 6
    originals and 12 augmented frames; validation is not augmented."""
    ip, mp = _w_paths(data_dir)
    sizes = []

    class Spy(loop.DeviceDataLoader):
        def __init__(self, images, masks, *a, **kw):
            sizes.append(images.shape[0])
            super().__init__(images, masks, *a, **kw)

    monkeypatch.setattr(loop, "DeviceDataLoader", Spy)
    seg = Segmenter(backbone="resnet_tiny", use_attention=False,
                    config=dict(CFG, num_epochs=1), device="cpu")
    seg.fit(ip[:6], mp[:6], ip[6:], mp[6:], augmentations_per_image=2)
    assert sizes == [18, 3]
    assert all(np.isfinite(m["loss"]) for m in seg.history["train_metrics"])
