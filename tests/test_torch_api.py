"""The port's ``Segmenter`` (segtpu_torch.api) on the CPU: fit → save →
from_checkpoint → predict, its result schema against the JAX package's,
port-trained weights carried back into ``segtpu``, and the parts left out.

Tolerances: predictions of a reloaded model are bit-identical (same
weights, same ops, same batch); other batchings within 1e-6 (the CPU's
convolutions sum in another order at another batch size); the JAX
package's logits on port-trained weights within atol 2e-4 of the
port's (tests/test_torch_models.py's bar for a whole converted model),
probabilities within 1e-4 (the sigmoid's slope is at most 1/4).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segtpu.infer.predict import predict_proba as jax_predict_proba
from segtpu.models.torch_convert import load_reference_checkpoint
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.api import Segmenter
from segtpu_torch.train.engine import METRIC_KEYS

S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share the host's cores: one intra-op thread
    per process keeps torch's thread pool from oversubscribing them (with
    a pool per process, these tests ran 100× slower beside the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed, n):
    r = np.random.default_rng(seed)
    im = r.normal(70, 12, (n, S, S)).clip(0, 255).astype(np.uint8)
    m = np.zeros((n, S, S), np.uint8)
    yy, xx = np.mgrid[:S, :S]
    for i in range(n):
        cy, cx = r.integers(8, 24, 2)
        b = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
        im[i][b] = np.clip(im[i][b].astype(int) + 90, 0, 255)
        m[i][b] = 1
    return im, m


@functools.lru_cache(maxsize=None)
def _fitted(backbone, use_attention):
    imgs, masks = _blobs(0, 10)
    seg = Segmenter(backbone=backbone, use_attention=use_attention,
                    config={"img_size": (S, S), "batch_size": 4,
                            "num_epochs": 2, "verbose": False, "seed": 1},
                    device="cpu")
    return seg.fit(imgs, masks), imgs, masks


def test_fit_history_has_the_reference_schema():
    seg, _, _ = _fitted("resnet_tiny", True)
    h = seg.history
    assert {"train_metrics", "val_metrics", "lr_history", "best_iou",
            "best_epoch", "best_model_state", "state", "training_time",
            "final_train_metrics", "final_val_metrics"} <= set(h)
    assert len(h["train_metrics"]) == 2 and len(h["lr_history"]) == 2
    assert set(h["final_val_metrics"]) == set(METRIC_KEYS)
    assert seg.state is h["state"]
    assert all(p.dtype == torch.float32 for p in seg.state.model.parameters())


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_save_from_checkpoint_predict_round_trip(tmp_path, use_attention):
    seg, imgs, masks = _fitted("resnet_tiny", use_attention)
    probs = seg.predict_proba(imgs[:3])
    assert probs.shape == (3, S, S, 1) and probs.dtype == np.float32
    assert np.isfinite(probs).all() and (0 <= probs).all() and \
        (probs <= 1).all()
    np.testing.assert_allclose(seg.predict_proba(imgs[:3], chunk=2),
                               probs, atol=1e-6)
    seg.save(str(tmp_path))
    cfg = json.loads((tmp_path / "segmenter_config.json").read_text())
    assert cfg["backbone"] == "resnet_tiny"
    assert cfg["use_attention"] is use_attention and cfg["img_size"] == [S, S]
    back = Segmenter.from_checkpoint(str(tmp_path), device="cpu")
    assert back.config["use_attention"] is use_attention
    np.testing.assert_array_equal(back.predict_proba(imgs[:3]), probs)
    np.testing.assert_array_equal(back.predict(imgs[:3]),
                                  (probs > 0.5).astype(np.uint8))
    assert back.evaluate(imgs[:4], masks[:4]) == seg.evaluate(imgs[:4],
                                                              masks[:4])
    # float inputs (preprocessed) give the same maps as uint8 inputs
    from segtpu_torch.data.preprocess import normalize_canonical
    x = normalize_canonical(torch.from_numpy(imgs[:3]))[:, 0].numpy()
    np.testing.assert_allclose(back.predict_proba(x), probs, atol=1e-6)


def test_evaluate_and_sweep_threshold():
    seg, imgs, masks = _fitted("resnet_tiny", True)
    m = seg.evaluate(imgs, masks)
    assert set(m) == set(METRIC_KEYS)
    sweep = seg.sweep_threshold(imgs, masks)
    assert len(sweep["thresholds"]) == 19
    # evaluate averages per-batch IoUs; the sweep scores the whole set
    from segtpu_torch.metrics import calculate_metrics
    whole = calculate_metrics(torch.from_numpy(seg.predict_proba(imgs)),
                              torch.from_numpy(masks))
    np.testing.assert_allclose(sweep["iou"][9], float(whole["iou"]),
                               atol=1e-6)
    post = seg.predict(imgs[:2], post_process_min_size=5)
    assert post.shape == (2, S, S, 1) and post.dtype == np.uint8


def test_port_trained_weights_load_into_the_jax_package(tmp_path):
    """The model file is a state_dict under the reference's key names:
    ``segtpu.models.torch_convert.load_reference_checkpoint`` reads it,
    and the JAX model then predicts what the port predicts."""
    seg, imgs, _ = _fitted("resnet34", True)
    seg.save(str(tmp_path))
    sd = torch.load(tmp_path / "segmenter.pt", weights_only=True)
    params, stats = load_reference_checkpoint(sd, "resnet34", True)
    jm = JaxUNet(backbone="resnet34", use_attention=True)
    from segtpu_torch.data.preprocess import normalize_canonical
    x = normalize_canonical(torch.from_numpy(imgs[:2]))
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x.permute(0, 2, 3, 1).numpy()), train=False)
    model = seg.state.model.eval()
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-4)
    state = type("S", (), {"params": params, "batch_stats": stats})
    np.testing.assert_allclose(
        seg.predict_proba(imgs[:2]),
        np.asarray(jax_predict_proba(jm, state, x.permute(0, 2, 3, 1)
                                     .numpy())), atol=1e-4)


def test_parts_left_out_raise_with_their_roadmap_item():
    seg, imgs, masks = _fitted("resnet_tiny", True)
    for call, item in (
            (lambda: seg.predict_proba(imgs[:1], tta=True), "A19"),
            (lambda: seg.predict_tiled(imgs[0]), "A19"),
            (lambda: seg.export("x"), "A20")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(RuntimeError, match="not fitted"):
        Segmenter(backbone="resnet_tiny", device="cpu").predict(imgs[:1])


def test_segmenter_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmenter(backbone="resnet_tiny")
