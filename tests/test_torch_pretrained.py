"""Pretrained encoders (segtpu_torch.models.torch_convert, the
``encoder_checkpoint`` config and ``Segmenter.load_pretrained_encoder``)
against the JAX package's converter, on the CPU.

The checkpoints are built by hand with torchvision's key names and shapes
and random weights from a ``torch.Generator`` (``chip_smoke.py``'s
``torchvision_state_dict``); nothing is downloaded and torchvision is not
needed. Both packages read the same file: the port through
``load_pretrained``, the JAX package through its
``load_torchvision_encoder``/``load_reference_checkpoint`` and
``merge_encoder``, onto the same fresh decoder (the port's, carried to
the JAX package by its ``load_reference_checkpoint``). Tensors must be
equal bit for bit; logits within 1e-4 of their largest magnitude in f32
(the tolerance of ``tests/test_torch_backbones.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import torchvision_state_dict
from segtpu.models import torch_convert as jax_convert
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.api import Segmenter
from segtpu_torch.models import torch_convert
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from segtpu_torch.train.loop import train_model

S = 32
BACKBONES = ("resnet34", "resnet50", "densenet121")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (several share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@functools.lru_cache(maxsize=None)
def _file_sd(backbone):
    return torchvision_state_dict(
        backbone, torch.Generator().manual_seed(BACKBONES.index(backbone)))


def _path(ckpt_dir, backbone, kind="torchvision"):
    p = ckpt_dir / f"{backbone}-{kind}.pth"
    if not p.exists():
        sd = _file_sd(backbone) if kind == "torchvision" else \
            _reference_sd(backbone)
        torch.save(sd, p)
    return str(p)


@functools.lru_cache(maxsize=None)
def _fresh_sd(backbone, use_attention=True):
    """The port model's fresh init from seed 0 (the decoder both packages
    keep)."""
    m = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                         device="cpu")
    return m.reset_parameters(torch.Generator().manual_seed(0)).state_dict()


@functools.lru_cache(maxsize=None)
def _reference_sd(backbone):
    """A whole reference ``UNetWithBackbone`` checkpoint: every tensor of
    the port's model redrawn, plus what a reference file also carries and
    the converters must not read (densenet's unused 3-channel
    ``features.conv0``)."""
    g = torch.Generator().manual_seed(10 + BACKBONES.index(backbone))
    sd = {k: (v if k.endswith("num_batches_tracked")
              else torch.rand(v.shape, generator=g) + 0.5)
          for k, v in _fresh_sd(backbone).items()}
    if backbone == "densenet121":
        sd["features.conv0.weight"] = torch.rand(64, 3, 7, 7, generator=g)
    return sd


def _port(backbone, path, kind="torchvision"):
    m = UNetWithBackbone(backbone=backbone, device="cpu")
    return torch_convert.load_pretrained(
        m, torch.Generator().manual_seed(0), path, kind=kind)


def _jax_variables(backbone, kind="torchvision"):
    """The JAX package's overlay of the same file onto the same fresh
    model."""
    params, stats = jax_convert.load_reference_checkpoint(
        _fresh_sd(backbone), backbone, True)
    if kind == "torchvision":
        ep, es = jax_convert.load_torchvision_encoder(_file_sd(backbone),
                                                      backbone)
    else:
        ep, es = jax_convert.load_reference_checkpoint(
            _reference_sd(backbone), backbone, True)
    return jax_convert.merge_encoder(params, stats, ep, es)


def _assert_same_tensors(model, params, stats, backbone):
    want = state_dict_from_jax(params, stats, backbone, True, device="cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k


@functools.lru_cache(maxsize=None)
def _jax_forward(backbone):
    """The JAX model's jitted eval forward, one compile per backbone."""
    jm = JaxUNet(backbone=backbone, use_attention=True)
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _assert_same_logits(model, params, stats, backbone):
    x = np.random.default_rng(5).uniform(0, 1, (2, S, S, 1)).astype(
        np.float32)
    want = np.asarray(_jax_forward(backbone)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)
                           .contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("backbone", BACKBONES)
def test_torchvision_checkpoint_matches_jax(ckpt_dir, backbone):
    model = _port(backbone, _path(ckpt_dir, backbone))
    params, stats = _jax_variables(backbone)
    _assert_same_tensors(model, params, stats, backbone)
    _assert_same_logits(model, params, stats, backbone)
    # the stem is the RGB kernel summed over its input channels, and the
    # decoder is the fresh init
    stem = "features.conv0.weight" if backbone == "densenet121" else \
        "conv1.weight"
    assert torch.equal(model.input_conv.weight,
                       _file_sd(backbone)[stem].sum(1, keepdim=True))
    assert torch.equal(model.upconv4.weight, _fresh_sd(backbone)[
        "upconv4.weight"])


@pytest.mark.parametrize("backbone", BACKBONES)
def test_reference_checkpoint_matches_jax(ckpt_dir, backbone):
    model = _port(backbone, _path(ckpt_dir, backbone, "reference"),
                  kind="reference")
    params, stats = _jax_variables(backbone, "reference")
    _assert_same_tensors(model, params, stats, backbone)
    if backbone == "densenet121":
        _assert_same_logits(model, params, stats, backbone)


def test_encoder_keys_cover_exactly_the_encoder():
    for backbone in BACKBONES:
        enc = torch_convert.load_torchvision_encoder(_file_sd(backbone),
                                                     backbone)
        own = {k for k in _fresh_sd(backbone)
               if not k.endswith("num_batches_tracked")
               and k.split(".")[0] in ("input_conv", "bn1", "enc1", "enc2",
                                       "enc3", "enc4", "features")}
        assert set(enc) == own, backbone
    with pytest.raises(ValueError, match="no torchvision layout"):
        torch_convert.load_torchvision_encoder({}, "resnet_tiny")
    with pytest.raises(ValueError, match="kind"):
        torch_convert.load_pretrained(None, None, "x.pth", kind="onnx")


def test_resolve_encoder_checkpoint_matches_jax():
    for ckpt in ("a.pth", {"resnet34": "r34.pth", "resnet50": "r50.pth"},
                 {"resnet50": "r50.pth"}, None):
        for backbone in BACKBONES:
            assert torch_convert.resolve_encoder_checkpoint(
                ckpt, backbone) == jax_convert.resolve_encoder_checkpoint(
                    ckpt, backbone)


def _blobs(n=4, seed=6):
    r = np.random.default_rng(seed)
    imgs = r.integers(0, 255, (n, S, S), dtype=np.uint8)
    return imgs, (imgs > 150).astype(np.uint8)


def test_load_pretrained_encoder_matches_jax(ckpt_dir):
    path = _path(ckpt_dir, "resnet34")
    seg = Segmenter(backbone="resnet34", device="cpu",
                    config={"seed": 0, "learning_rate": 3e-4,
                            "weight_decay": 2e-5, "img_size": (S, S)})
    assert seg.load_pretrained_encoder(path) is seg
    params, stats = _jax_variables("resnet34")
    _assert_same_tensors(seg.state.model, params, stats, "resnet34")
    group = seg.state.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (3e-4, 2e-5)
    probs = seg.predict_proba(_blobs()[0])
    assert probs.shape == (4, S, S, 1) and np.isfinite(probs).all()


def test_fit_with_encoder_checkpoint(ckpt_dir):
    """``encoder_checkpoint`` as a {backbone: path} mapping: before any
    step the model is the seed's fresh init with the file's encoder (the
    JAX package's overlay); a backbone the mapping lacks starts fresh; a
    1-epoch fit from the checkpoint trains."""
    imgs, masks = _blobs()
    path = _path(ckpt_dir, "resnet34")
    cfg = {"img_size": (S, S), "batch_size": 2, "seed": 0, "verbose": False,
           "loss_fn": "bce", "encoder_checkpoint": {"resnet34": path}}
    res = train_model(None, imgs[:3], masks[:3], imgs[3:], masks[3:],
                      num_epochs=0, device="cpu",
                      config={**cfg, "backbone": "resnet34"})
    # every tensor as the JAX overlay, so the final bias is the fresh
    # init's 0: a BCE run from a checkpoint sets no foreground prior
    params, stats = _jax_variables("resnet34")
    _assert_same_tensors(res["state"].model, params, stats, "resnet34")
    # no entry for resnet_tiny: the seed's fresh init, with the foreground
    # prior a from-scratch BCE run sets
    res = train_model(None, imgs[:3], masks[:3], imgs[3:], masks[3:],
                      num_epochs=0, device="cpu",
                      config={**cfg, "backbone": "resnet_tiny"})
    fresh = UNetWithBackbone(backbone="resnet_tiny", device="cpu")
    fresh = fresh.reset_parameters(torch.Generator().manual_seed(0))
    got = res["state"].model.state_dict()
    for k, v in fresh.state_dict().items():
        if k != "conv_final.bias":
            assert torch.equal(got[k], v), k
    assert not torch.equal(got["conv_final.bias"],
                           fresh.state_dict()["conv_final.bias"])
    seg = Segmenter(backbone="resnet34", device="cpu",
                    config={**cfg, "num_epochs": 1})
    seg.fit(imgs, masks)
    hist = seg.history
    assert len(hist["train_metrics"]) == 1
    assert np.isfinite(hist["train_metrics"][0]["loss"])
