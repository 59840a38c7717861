"""Training on a (data × spatial) mesh in the port (ROADMAP A24): a batch
placed ``[Shard(0), Shard(2)]`` by ``distribute_tensor`` on gloo ranks on
the CPU (``tests/torch_dist_worker.py``), against the JAX package's
single-device step on the whole batch, GSPMD's contract for a batch
placed ``P("data", "spatial")``.

Bars, and why:

- the 2×2 mesh's float64 step (resnet_tiny with attention, combo loss,
  SGD, 64², global B=4: blocks of 2 images, bands of 32 rows) against
  the JAX package's float64 ``_train_step``: parameters within 1e-9 of
  the largest parameter and each running statistic within 1e-9 of its
  tensor's largest entry, loss and metrics within 1e-12 of themselves
  (the same mathematics summed in other orders; ``test_torch_parallel``'s
  2-rank step measured 2.2e-13). SGD, because Adam's first step,
  lr·g/(|g| + ε), hides a wrong reduction (``test_torch_parallel``);
- the accumulated step (A=2), the eval step and the ``reparam_in_train``
  step on bands, and resnet50's and densenet121's forward and backward,
  against the same port in one process: 1e-9 of the same scales
  (measured ≤ 1e-12), the f32 eval step's metrics within 1e-5 of
  themselves;
- the two controls, each rank's band with its own edge rows replicated
  in place of its neighbours' (what the inference predictor does at the
  image's edges), and a rank-local mean in the channel attention, must
  miss the parameter bar by at least a factor of 100 (measured 780× and
  160×; their statistics and gradients miss by 1e7 and more).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu.train.engine import get_engine as jax_get_engine
from segtpu_torch.models.backbones import MaxPool
from segtpu_torch.models.unet import UNetWithBackbone
from segtpu_torch.parallel.spatial import Bands, on_bands
from test_torch_parallel import _f64_state_dict, _nchw
from torch_dist_worker import launch

S, B, LR, WD = 64, 4, 1e-3, 1e-5
CFG = {"use_attention": True, "optimizer": "sgd"}
BAR = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2×2 mesh's run (4 ranks), then the 1×2 mesh's (2 ranks), started
    on the JAX model's initial weights. The JAX package's
    float64 step on the whole batch is computed first and handed to the
    ranks with their inputs, which compare their steps with it."""
    tmp = tmp_path_factory.mktemp("spatial_train")
    r = np.random.default_rng(0)
    x = r.uniform(0, 1, (B, S, S, 1))
    y = (x > 0.6).astype(np.float64)
    x2 = r.uniform(0, 1, (B, S, S, 1))
    with jax.enable_x64(True):
        jm = JaxUNet(backbone="resnet_tiny", use_attention=True)
        # the parameters do not depend on the input size: 32² compiles
        # faster
        p, s = create_model_state(jm, jax.random.key(0), (1, 32, 32, 1))
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                for t in (p, s))
        eng = jax_get_engine({"backbone": "resnet_tiny", "loss_fn": "combo",
                              "dtype": "float64", **CFG})
        st, m = eng._train_step(eng.state_from(p, s, LR, WD),
                                jnp.asarray(x), jnp.asarray(y))
        want = {"sd": _f64_state_dict(jax.device_get(st.params),
                                      jax.device_get(st.batch_stats)),
                "metrics": {k: float(v) for k, v in m.items()}}
        torch.save({"state_dict": _f64_state_dict(jax.device_get(p),
                                                  jax.device_get(s)),
                    "x": _nchw(x), "y": _nchw(y), "x2": _nchw(x2),
                    "y2": _nchw((x2 > 0.6).astype(np.float64)),
                    "lr": LR, "wd": WD, "cfg": CFG, "want": want},
                   tmp / "inputs.pt")
    # one launch at a time, so that the suite's other workers keep their
    # cores
    return {name: launch(name, world, tmp)
            for name, world in (("mesh2d", 4), ("bands", 2))}


def test_mesh_step_matches_jax_single_device_step_in_float64(runs):
    """Every rank of the 2×2 mesh holds the JAX package's single-device
    step on the whole batch after one step: parameters, running
    statistics, loss and metrics (errors computed on the ranks), each
    BatchNorm updated once, and the same tensors on every rank."""
    for rank in runs["mesh2d"]:
        err = rank["step"]
        assert err["params"] <= BAR and err["stats"] <= BAR \
            and err["metrics"] <= 1e-12, err
        assert rank["tracked"] and set(rank["tracked"]) == {1}
    first = runs["mesh2d"][0]["digest"]
    assert all(rank["digest"] == first for rank in runs["mesh2d"][1:])


@pytest.mark.parametrize("control", ["edge_replicated", "rank_local_mean"])
def test_controls_miss_the_bar(runs, control):
    """Negative controls: bands padded with their own edge rows in place
    of the neighbours' rows, and a channel attention that pools each band
    alone, both miss the parameter bar by 100× or more."""
    for rank in runs["mesh2d"]:
        err = rank[control]
        assert err["params"] >= 100 * BAR and err["stats"] >= 100 * BAR, err


def test_mesh_accumulated_step_matches_one_process(runs):
    """``train_step_accum`` on stacked micro-batches placed [Shard(1),
    Shard(3)]: A=2 micro-batches of 4 images."""
    r0 = runs["mesh2d"][0]
    assert max(r0["accum"].values()) <= BAR, r0["accum"]
    assert all(rank["accum_digest"] == r0["accum_digest"]
               for rank in runs["mesh2d"])


def test_mesh_eval_step_matches_one_process(runs):
    """The eval step on the bands (halo rows and the channel attention's
    pooling; BatchNorm's running statistics), float64 without the gate
    kernel and f32 with it (its plain version on the CPU)."""
    r0 = runs["mesh2d"][0]
    for rank in runs["mesh2d"]:
        torch.testing.assert_close(rank["eval"], r0["eval_ref"], rtol=1e-12,
                                   atol=0)
        torch.testing.assert_close(rank["eval_f32"], r0["eval_f32_ref"],
                                   rtol=1e-5, atol=0)


def test_band_height_not_a_multiple_of_32_is_refused(runs):
    for rank in runs["mesh2d"]:
        assert "bands of 16 rows" in rank["refused"]
        assert "multiple of 32" in rank["refused"]


def test_data_only_placement_on_the_2d_mesh_keeps_the_data_parallel_path(
        runs):
    """A batch placed [Shard(0), Replicate()] on the 2×2 mesh (what
    ``shard_loader`` gives) is split over ``data`` alone: no bands."""
    for rank in runs["mesh2d"]:
        assert rank["data_only"] == (2, False)


def test_reparam_in_train_step_on_a_1x2_mesh_matches_one_process(runs):
    """resnet_tiny with ``reparam_in_train`` (the s2d stem with its own
    halo, 2 rows above and 1 below at half resolution; the contracted
    head) on bands of 32 rows over 2 ranks, global B=2, float64, SGD."""
    r0, r1 = runs["bands"]
    assert max(r0["reparam"].values()) <= BAR, r0["reparam"]
    assert r0["reparam_digest"] == r1["reparam_digest"]


@pytest.mark.parametrize("backbone", ["resnet50", "densenet121"])
def test_encoders_forward_and_backward_on_a_1x2_mesh_match_one_process(
        runs, backbone):
    """resnet50 (its Bottlenecks' 3×3/s2) and densenet121 (its plain 7×7
    stem, dense layers and max-pool) with attention, one train-mode
    forward and one backward on bands of 32 rows over 2 ranks, float64:
    the loss, every running statistic, and the summed gradients of the
    stem and of every BatchNorm and bias (each carries its layer's
    backward) against one process."""
    ref = runs["bands"][0][backbone + "_ref"]
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for rank in runs["bands"]:
        got = rank[backbone]
        assert abs(got["loss"] - ref["loss"]) <= BAR * abs(ref["loss"])
        assert max(float((got["grads"][k] - g).abs().max())
                   for k, g in ref["grads"].items()) <= BAR * gmax
        for k, v in ref["stats"].items():
            assert float((got["stats"][k] - v).abs().max()) <= \
                BAR * float(v.abs().max()), k


class _Group:
    """A stand-in process group of two ranks (no collective is made)."""

    def size(self):
        return 2

    def rank(self):
        return 0


def test_a_layer_without_halo_rows_is_refused_before_any_forward():
    """No silent fallback: a 3×3 conv that cannot take halo rows, or a
    torch pooling layer, in the model refuses ``on_bands``; the model's
    own layers pass, and leave the context clean."""
    model = UNetWithBackbone(backbone="resnet_tiny", device="cpu")
    bands = Bands(_Group(), 64)
    with on_bands(model, bands):
        assert model.decoder1[0].bands is bands
        assert model.maxpool.bands is bands
        assert model.ch_attention1.bands is bands
    assert model.decoder1[0].bands is None
    for name, layer in (("decoder1.0", torch.nn.Conv2d(96, 32, 3,
                                                       padding=1)),
                        ("maxpool", torch.nn.MaxPool2d(3, 2, 1))):
        bad = UNetWithBackbone(backbone="resnet_tiny", device="cpu")
        parent, _, leaf = name.rpartition(".")
        setattr(bad.get_submodule(parent) if parent else bad, leaf, layer)
        with pytest.raises(ValueError, match=f"{name} .*cannot run on a "
                                             f"band"):
            with on_bands(bad, bands):
                pass
    assert isinstance(model.maxpool, MaxPool)
    with pytest.raises(ValueError, match="multiple of 32"):
        Bands(_Group(), 96)
