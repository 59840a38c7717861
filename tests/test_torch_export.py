"""The port's serving export (segtpu_torch.infer.export) against the JAX
package's, case for case with tests/test_export.py (its HTTP cases are in
tests/test_torch_serve.py): the same U-Net weights (moved across by
``state_dict_from_jax``) and the same numpy inputs, the port's artifact
beside JAX's; then the port's own cases (the no-attention symbolic-batch
export, the live model after an export; the autocast region of a bf16
artifact is in tests/test_torch_serve.py, whose artifact is one).

Tolerances, and why:
- the port's artifact against the port's live model on the same device,
  f32: atol 1e-6, as tests/test_export.py (the same ops, traced);
- the port against JAX, f32: probabilities atol 1e-4, the bar of
  tests/test_torch_predict.py (the packages sum convolutions in other
  orders);
- the no-attention artifact, whose upsample routing is frozen at batch
  16, against the live model at batches 1 and 5: atol 1e-5 (the fused
  and the unfused upsample sum in other orders).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from segtpu.infer import export as jexport
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu_torch.api import Segmenter
from segtpu_torch.infer import export as texport
from segtpu_torch.infer.predict import nhwc_forward, predict_proba
from segtpu_torch.infer.tiled import _halo_many, make_tiled_predictor
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from segtpu_torch.train.engine import TrainState
from torch_jax_init import drawn_variables

ROOT = Path(__file__).resolve().parent.parent
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(backbone, use_attention, n_classes=1, seed=0):
    jm = JaxUNet(backbone=backbone, use_attention=use_attention,
                 n_classes=n_classes)
    p, s = drawn_variables(jm, seed, (1, SIZE, SIZE, 1))
    r = np.random.default_rng(seed + 11)
    s = jax.tree_util.tree_map_with_path(
        lambda k, v: (r.normal(size=v.shape) * 0.05 if k[-1].key == "mean"
                      else r.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        s)
    tm = UNetWithBackbone(backbone=backbone, use_attention=use_attention,
                          n_classes=n_classes, device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, backbone, use_attention,
                                           device="cpu"), strict=True)
    return jm, p, s, tm.eval()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A 32² attention U-Net (resnet_tiny) in both packages, each exported
    once with a symbolic batch; around the port's export, the live
    model's output and its gates' fold cache."""
    jm, p, s, tm = _pair("resnet_tiny", True)
    root = tmp_path_factory.mktemp("served")
    x = np.random.default_rng(8).random((2, SIZE, SIZE, 1), np.float32)
    before = _live(tm, x)
    gates = [getattr(tm, f"attention{lvl}") for lvl in (4, 3, 2, 1)]
    cache = [(g._fold_key, g._folded) for g in gates]
    port = texport.save_serving(str(root / "port"), tm, (SIZE, SIZE))
    return SimpleNamespace(
        jm=jm, params=p, stats=s, tm=tm, port=port, x=x, before=before,
        cache=cache, cache_after=[(g._fold_key, g._folded) for g in gates],
        jax=jexport.save_serving(str(root / "jax"), jm, p, s, (SIZE, SIZE)))


@pytest.fixture(scope="module")
def sm(served):
    return texport.ServingModel(served.port, device="cpu")


def _live(tm, x):
    return predict_proba(tm, x, device="cpu")


def test_export_matches_live_model_any_batch(served, sm):
    rng = np.random.default_rng(0)
    for batch in (1, 3, 5):
        x = rng.random((batch, SIZE, SIZE, 1), np.float32)
        got = sm.predict_proba(x)
        assert got.shape == (batch, SIZE, SIZE, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, _live(served.tm, x), atol=1e-6)
    np.testing.assert_allclose(
        got, jexport.ServingModel(served.jax).predict_proba(x), atol=1e-4)


_BLOCKED_MODELS = """
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[:2] == ["segtpu_torch", "models"]:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(1)
from segtpu_torch.infer.export import ServingModel
sm = ServingModel(sys.argv[1], device="cpu")
np.save(sys.argv[3], sm.predict_proba(np.load(sys.argv[2])))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("segtpu", "segtpu_torch",
                                               "jax", "flax"))))
"""


def test_artifact_is_self_contained(served, tmp_path):
    """The artifact loads and serves in a process where
    ``segtpu_torch.models`` cannot be imported: the weights are in it and
    the ops come from ``segtpu_torch.kernels``."""
    x = np.full((2, SIZE, SIZE, 1), 0.5, np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_MODELS, served.port,
         str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "segtpu_torch.kernels" in mods
    assert not [m for m in mods if m.startswith("segtpu_torch.models")
                or m.split(".")[0] in ("segtpu", "jax", "flax")]
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               _live(served.tm, x), atol=1e-6)
    meta = json.load(open(os.path.join(served.port, "meta.json")))
    jmeta = json.load(open(os.path.join(served.jax, "meta.json")))
    assert meta["img_size"] == [SIZE, SIZE] and meta["format_version"] >= 1
    assert set(jmeta) <= set(meta)


def test_serving_model_validates_input(sm):
    with pytest.raises(ValueError, match="resize"):
        sm.predict_proba(np.zeros((1, SIZE * 2, SIZE * 2, 1), np.float32))
    with pytest.raises(ValueError, match="1-channel"):
        sm.predict_proba(np.zeros((1, SIZE, SIZE, 3), np.float32))
    masks = sm.predict(np.zeros((2, SIZE, SIZE), np.float32))
    assert masks.dtype == np.uint8 and set(np.unique(masks)) <= {0, 1}


def test_multiplatform_export_runs_on_cpu(served, sm, tmp_path):
    """An artifact names the devices it serves on (``platforms``, both by
    default) and runs on the CPU (matching JAX's there: the any-batch
    case); a loader refuses a device the artifact was not exported
    for."""
    assert sm.meta["platforms"] == ["cpu", "cuda"]
    assert sm.meta["exported_on"] == "cpu"
    x = np.random.default_rng(5).random((2, SIZE, SIZE, 1), np.float32)
    np.testing.assert_allclose(sm.predict_proba(x), _live(served.tm, x),
                               atol=1e-6)
    with pytest.raises(ValueError, match="platforms"):
        texport.export_serving(served.tm, (SIZE, SIZE), platforms=("tpu",))
    only_cuda = tmp_path / "cuda"
    shutil.copytree(served.port, only_cuda)
    meta = json.load(open(only_cuda / "meta.json"))
    json.dump(dict(meta, platforms=["cuda"]), open(only_cuda / "meta.json",
                                                   "w"))
    with pytest.raises(ValueError, match="exported for"):
        texport.ServingModel(str(only_cuda), device="cpu")


def test_fixed_batch_export(served, tmp_path):
    path = texport.save_serving(str(tmp_path / "b2"), served.tm,
                                (SIZE, SIZE), batch=2)
    sm = texport.ServingModel(path, device="cpu")
    assert sm.meta["batch"] == 2
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 1), np.float32)
    np.testing.assert_allclose(sm.predict_proba(x), _live(served.tm, x),
                               atol=1e-6)
    with pytest.raises(ValueError, match="fixed batch"):
        sm.predict_proba(np.zeros((3, SIZE, SIZE, 1), np.float32))
    with pytest.raises(Exception):       # the graph itself refuses it too
        sm._module(torch.zeros((3, SIZE, SIZE, 1)))


def test_exported_artifact_composes_with_tiled_inference(served):
    """A logits artifact (``with_sigmoid=False``) plugs into the tiled
    predictor as its ``apply_fn`` and matches the live-model tiled path."""
    ep = texport.export_serving(served.tm, (SIZE, SIZE), with_sigmoid=False)
    big = np.random.default_rng(3).random((3 * SIZE, 2 * SIZE, 1),
                                          np.float32)
    kw = dict(tile=SIZE, overlap=8, batch_tiles=4)
    with torch.inference_mode():
        want = make_tiled_predictor(
            lambda x: nhwc_forward(served.tm, x), **kw)(big)
        got = make_tiled_predictor(ep.module(), **kw)(big)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_serving_model_tiled_matches_live_halo(served, sm):
    """``predict_proba_tiled`` (halo) equals the halo predictor over the
    live model's probabilities, ragged sizes included, and JAX's tiled
    serving; blend mode overlap-adds probabilities."""
    big = np.random.default_rng(5).random((2, SIZE + 20, 2 * SIZE + 5),
                                          np.float32)

    def live_probs(x):
        return torch.sigmoid(nhwc_forward(served.tm, x).float())

    got = sm.predict_proba_tiled(big, overlap=16)      # halo 8 → tile 16
    with torch.inference_mode():
        want = _halo_many(live_probs, SIZE - 16, 8, None)(
            torch.from_numpy(big[..., None])).numpy()
        want_b = make_tiled_predictor(live_probs, tile=SIZE, overlap=8)
        want_b = torch.stack([want_b(torch.from_numpy(im[..., None]))
                              for im in big]).numpy()
    assert got.shape == (2, SIZE + 20, 2 * SIZE + 5, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    jsm = jexport.ServingModel(served.jax)
    np.testing.assert_allclose(got, jsm.predict_proba_tiled(big, overlap=16),
                               atol=1e-4)
    got_b = sm.predict_proba_tiled(big, overlap=8, mode="blend")
    np.testing.assert_allclose(got_b, want_b, atol=1e-5)
    with pytest.raises(ValueError, match="halo overlap"):
        sm.predict_proba_tiled(big, overlap=SIZE)
    with pytest.raises(ValueError, match="mode"):
        sm.predict_proba_tiled(big, mode="mosaic")


def _segmenter(use_attention, dtype="float32", n_classes=1):
    seg = Segmenter(backbone="resnet_tiny", use_attention=use_attention,
                    n_classes=n_classes, device="cpu",
                    config={"img_size": (SIZE, SIZE), "dtype": dtype})
    model = seg.engine.build_model().reset_parameters(
        torch.Generator().manual_seed(1))
    seg.state = TrainState(model)
    return seg


@pytest.fixture(scope="module")
def multiclass(tmp_path_factory):
    """A 3-class, no-attention Segmenter exported through
    ``Segmenter.export``, and its ServingModel."""
    seg = _segmenter(False, n_classes=3)
    path = seg.export(str(tmp_path_factory.mktemp("mc") / "served"))
    return seg, texport.load_serving(path, device="cpu")


def test_segmenter_export_roundtrip(multiclass):
    seg, sm = multiclass
    x = np.random.default_rng(1).random((4, SIZE, SIZE, 1), np.float32)
    np.testing.assert_allclose(sm.predict_proba(x), seg.predict_proba(x),
                               atol=1e-6)
    np.testing.assert_array_equal(sm.predict(x), seg.predict(x))


def test_multiclass_export_roundtrip(multiclass):
    """A softmax model exports with the channel softmax inside: its
    probabilities sum to 1, ``predict`` gives argmax class ids, and meta
    records the activation."""
    seg, sm = multiclass
    assert sm.meta["activation"] == "softmax" and sm.meta["n_classes"] == 3
    x = np.random.default_rng(7).random((2, SIZE, SIZE, 1), np.float32)
    probs = sm.predict_proba(x)
    assert probs.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    masks = sm.predict(x)
    assert masks.shape == (2, SIZE, SIZE, 1) and masks.max() <= 2
    np.testing.assert_array_equal(
        masks[..., 0], np.argmax(probs, axis=-1).astype(np.uint8))


# ------------------------------------------------------ the port's cases

def _graph_ops(ep) -> dict:
    ops = {}
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function":
                    ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def test_no_attention_export_has_symbolic_batch_and_fused_levels(tmp_path):
    """Without attention the upsample routing is decided at the nominal
    batch (16) and frozen: the graph holds the upsample op at those
    levels, ``meta.json`` names them, and any batch runs, 1 included
    (where the live model would not fuse level 4)."""
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=False,
                          fuse_min_work=16, device="cpu").eval()
    tm.reset_parameters(torch.Generator().manual_seed(2))
    size = SIZE
    path = texport.save_serving(str(tmp_path / "na"), tm, (size, size))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["fused_upsample_levels"] == [2, 3, 4]
    assert meta["routing_batch"] == 16 and meta["batch"] is None
    ep = torch.export.load(os.path.join(path, "model.pt2"))
    assert _graph_ops(ep).get("segtpu_torch.upsample2x_concat.default") == 3
    sm = texport.ServingModel(path, device="cpu")
    rng = np.random.default_rng(3)
    for batch in (1, 5):
        x = rng.random((batch, size, size, 1), np.float32)
        np.testing.assert_allclose(sm.predict_proba(x), _live(tm, x),
                                   atol=1e-5)
    assert tm._routing_batch is None


def test_live_model_is_unchanged_by_an_export(served):
    """The export traces with grad enabled: the gates' fold cache is left
    as it was, and the live model's output is the same after it."""
    assert served.cache_after == served.cache
    np.testing.assert_array_equal(_live(served.tm, served.x), served.before)
