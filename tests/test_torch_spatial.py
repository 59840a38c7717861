"""The port's row-sharded (halo-exchange) inference
(segtpu_torch.parallel.spatial) on 2 gloo ranks on the CPU
(``tests/torch_dist_worker.py``), case for case with
tests/test_spatial.py, and against the JAX package's ``spatial_predict``
on a 2-device mesh.

Bars, and why: the identity-style and halo-0 cases are exact (atol
1e-6); the 2-conv stack equals the dense forward within 1e-5 except the
image's own 2 top and bottom rows, where edge replication differs from
the dense forward's zero padding (tests/test_spatial.py's bars); the
resnet_tiny attention U-Net's probabilities within 1e-5 of the JAX
package's at the same band count (the result depends on N, so both use
2 bands) on the same weights.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from segtpu.core.dist import create_mesh as jax_create_mesh
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.parallel import spatial_predict as jax_spatial_predict
from segtpu.train.engine import TrainState as JaxTrainState
from segtpu_torch.models.convert import state_dict_from_jax
from torch_dist_worker import _conv_stack, launch
from torch_jax_init import drawn_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(1)
    k1 = rng.normal(size=(3, 3, 1, 4), scale=0.5).astype(np.float32)
    k2 = rng.normal(size=(3, 3, 4, 2), scale=0.5).astype(np.float32)
    jm = JaxUNet(backbone="resnet_tiny", use_attention=True)
    params, stats = drawn_variables(jm, 0, (1, 64, 64, 1))
    slide = np.random.default_rng(2).random((128, 64)).astype(np.float32)
    mesh = jax_create_mesh(axis_sizes=(2,))
    want = jax_spatial_predict(jm, JaxTrainState(params, stats, None), slide,
                               mesh, halo=16)
    inputs = {
        "img": torch.from_numpy(rng.normal(size=(64, 40, 1))
                                .astype(np.float32)),
        "img2": torch.from_numpy(rng.normal(size=(64, 48, 1))
                                 .astype(np.float32)),
        # HWIO → OIHW
        "k1": torch.from_numpy(k1.transpose(3, 2, 0, 1).copy()),
        "k2": torch.from_numpy(k2.transpose(3, 2, 0, 1).copy()),
        "state_dict": state_dict_from_jax(params, stats, "resnet_tiny", True,
                                          device="cpu"),
        "slide": slide}
    torch.save(inputs, tmp / "inputs.pt")
    return {"ranks": launch("spatial", 2, tmp), "inputs": inputs,
            "want": np.asarray(want)}


def _whole(run, key):
    return torch.cat([r[key] for r in run["ranks"]]).numpy()


def test_identity_exact(run):
    img = run["inputs"]["img"].numpy()
    np.testing.assert_allclose(_whole(run, "identity"), img * 2.0,
                               atol=1e-6)


def test_matches_dense_for_small_receptive_field(run):
    """Receptive radius 2, halo 4: equal to the dense forward except the
    image's own top and bottom 2 rows."""
    inp = run["inputs"]
    dense = _conv_stack(inp["k1"], inp["k2"])(inp["img2"][None])[0].numpy()
    out = _whole(run, "conv")
    assert out.shape == dense.shape
    np.testing.assert_allclose(out[2:-2], dense[2:-2], atol=1e-5)


def test_halo_zero_is_bandwise_forward(run):
    np.testing.assert_allclose(_whole(run, "halo0"), 2.0, atol=1e-6)


def test_refusals_carry_the_jax_packages_messages(run):
    for r in run["ranks"]:
        e = r["errors"]
        assert "must divide evenly over 2 devices" in e["uneven"]
        assert "exceeds the per-device band height 16" in e["band"]
        assert "halo must be ≥ 0" in e["negative"]


def test_exchange_is_point_to_point_not_a_gather(run):
    """A profiled predictor call records sends and receives of the halo
    rows and no all-gather of the image."""
    for r in run["ranks"]:
        assert r["ops"] == ["recv", "send"]


def test_spatial_predict_matches_jax_on_two_bands(run):
    want = run["want"]
    for r in run["ranks"]:
        got = r["probs"]
        assert got.shape == want.shape == (128, 64, 1)
        np.testing.assert_allclose(got, want, atol=1e-5)
