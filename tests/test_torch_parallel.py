"""The port's data parallelism (segtpu_torch.parallel, core.dist) against
the JAX package's single-device step, on gloo ranks on the CPU
(``tests/torch_dist_worker.py``).

GSPMD's contract, which the port keeps: a data-parallel step equals the
single-device step on the same global batch. Bars, and why:

- a 2-rank float64 step (resnet_tiny with attention, combo loss, 32²,
  global B=4, SGD) against the JAX package's ``_train_step`` in float64
  on the same weights: loss, metrics, parameters and BatchNorm running
  statistics within 1e-8 of each quantity's largest magnitude
  (measured: loss and metrics 1.1e-15, parameters 2.2e-13, running
  statistics 1.4e-14). SGD, because Adam's first update, lr·g/(|g| + ε),
  multiplies a gradient's rounding by up to lr/ε = 1e5 where g ≈ 0: the
  port's single-device Adam step already parts from the JAX package's
  by 1.02e-8 of the largest parameter that way. The same step with Adam
  is held against the port's single-device Adam step at 1e-8;
- the negative control, each rank's half stepped on its own and the two
  results averaged (what rank-local BatchNorm and losses would give),
  misses that bar by at least 1e-4 (measured: running statistics 0.64,
  metrics 1.2e-2, parameters 3.6e-5);
- the accumulated step, the epoch over sharded loaders and the 4-rank
  epoch whose batches leave ranks uneven and empty against the port's
  single-device float64 run: parameters within 1e-9 of the largest
  parameter, each running statistic within 1e-9 of its tensor's largest
  entry, epoch totals within 1e-9 relative. Every batch here has at
  least 3 rows: with 2, resnet_tiny's 1×1 level normalises each channel
  to ±1, the residual sums there cancel to a rounding error, and ReLU's
  gradient at that tie flips with any change of rounding order (seen
  with 2-row micro-batches: a bias gradient of 4e-5 off by 3e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import create_model_state
from segtpu.train.engine import get_engine as jax_get_engine
from segtpu_torch.models.convert import state_dict_from_jax
from segtpu_torch.train.engine import METRIC_KEYS, TrainState, get_engine
from torch_dist_worker import launch

S, B, LR, WD = 32, 4, 1e-3, 1e-5
CFG = {"use_attention": True, "optimizer": "sgd"}
CFG_ADAM = {"use_attention": True}
BAR = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(a, (0, 3, 1, 2)))).double().contiguous(
            memory_format=torch.channels_last)


def _f64_state_dict(params, stats):
    """Float64 JAX trees as the port's float64 state_dict (the f32 head
    plus the f32 remainder, since ``state_dict_from_jax`` converts to
    float32)."""
    def split(t):
        hi = jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        return hi, jax.tree.map(
            lambda a, h: np.asarray(np.asarray(a) - h, np.float32), t, hi)

    (ph, pl), (sh, sl) = split(params), split(stats)
    hi = state_dict_from_jax(ph, sh, "resnet_tiny", True, device="cpu")
    lo = state_dict_from_jax(pl, sl, "resnet_tiny", True, device="cpu")
    return {k: (hi[k].double() + lo[k].double()) if hi[k].is_floating_point()
            else hi[k] for k in hi}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX package's float64 step and the 2-rank run's results."""
    tmp = tmp_path_factory.mktemp("dp")
    r = np.random.default_rng(0)
    x = r.uniform(0, 1, (B, S, S, 1))
    y = (x > 0.6).astype(np.float64)
    ex = r.uniform(0, 1, (7, S, S, 1))
    vx = r.uniform(0, 1, (3, S, S, 1))
    with jax.enable_x64(True):
        jm = JaxUNet(backbone="resnet_tiny", use_attention=True)
        p, s = create_model_state(jm, jax.random.key(0), (1, S, S, 1))
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                for t in (p, s))
        eng = jax_get_engine({"backbone": "resnet_tiny", "loss_fn": "combo",
                              "dtype": "float64", **CFG})
        st, m = eng._train_step(eng.state_from(p, s, LR, WD),
                                jnp.asarray(x), jnp.asarray(y))
        want = _f64_state_dict(jax.device_get(st.params),
                               jax.device_get(st.batch_stats))
        want_m = {k: float(v) for k, v in m.items()}
        sd = _f64_state_dict(jax.device_get(p), jax.device_get(s))
    inputs = {"state_dict": sd, "x": _nchw(x), "y": _nchw(y),
              "ex": _nchw(ex), "ey": _nchw((ex > 0.6).astype(np.float64)),
              "vx": _nchw(vx), "vy": _nchw((vx > 0.6).astype(np.float64)),
              "lr": LR, "wd": WD, "cfg": CFG, "cfg_adam": CFG_ADAM}
    torch.save(inputs, tmp / "inputs.pt")
    return {"ranks": launch("dp", 2, tmp), "want": want, "want_m": want_m,
            "inputs": inputs}


def _err(got: dict, want: dict, keys) -> float:
    """max |got − want| over ``keys`` relative to the largest |want|."""
    scale = max(float(want[k].abs().max()) for k in keys)
    return max(float((got[k] - want[k]).abs().max()) for k in keys) / scale


def _params_and_stats(sd):
    params = [k for k in sd if "running" not in k
              and not k.endswith("num_batches_tracked")]
    stats = [k for k in sd if "running" in k]
    return params, stats


def _metric_err(got: dict, want: dict) -> float:
    scale = max(abs(v) for v in want.values())
    return max(abs(got[k] - want[k]) for k in METRIC_KEYS) / scale


def test_dp_step_matches_jax_single_device_step_in_float64(dp):
    """Both ranks hold the same state after the step, and it is the JAX
    package's single-device step on the global batch."""
    want, want_m = dp["want"], dp["want_m"]
    params, stats = _params_and_stats(want)
    for rank in dp["ranks"]:
        got = rank["cfg"]["sd"]
        assert _metric_err(rank["cfg"]["metrics"], want_m) <= BAR
        assert _err(got, want, params) <= BAR
        for k in stats:     # each statistic within 1e-8 of its own scale
            assert _err(got, want, [k]) <= BAR, k
        assert all(int(got[k]) == 1 for k in got
                   if k.endswith("num_batches_tracked"))
    a, b = (r["cfg"]["sd"] for r in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dp_adam_step_matches_single_device_adam_step(dp):
    ref = dp["ranks"][0]["adam_ref"]
    params, stats = _params_and_stats(ref["sd"])
    for rank in dp["ranks"]:
        got = rank["cfg_adam"]
        assert _metric_err(got["metrics"], ref["metrics"]) <= BAR
        assert _err(got["sd"], ref["sd"], params) <= BAR
        for k in stats:
            assert _err(got["sd"], ref["sd"], [k]) <= BAR, k


def test_rank_local_steps_averaged_miss_the_bar(dp):
    """Negative control: each rank's half stepped alone (rank-local
    BatchNorm statistics and loss), the two results averaged, misses the
    bar above by at least 1e-4."""
    inputs, want, want_m = dp["inputs"], dp["want"], dp["want_m"]
    engine = get_engine({"backbone": "resnet_tiny", "loss_fn": "combo",
                         **CFG}, device="cpu")
    sds, ms = [], []
    for half in (slice(0, B // 2), slice(B // 2, B)):
        model = engine.build_model()
        model.load_state_dict(inputs["state_dict"])
        model.double()
        st = TrainState(model, engine.make_optimizer(model, LR, WD))
        st, m = engine.train_step(st, inputs["x"][half], inputs["y"][half])
        sds.append(st.model.state_dict())
        ms.append({k: float(v) for k, v in m.items()})
    avg = {k: (sds[0][k] + sds[1][k]) / 2 for k in want
           if want[k].is_floating_point()}
    params, stats = _params_and_stats(want)
    worst = max(_metric_err({k: (ms[0][k] + ms[1][k]) / 2
                             for k in METRIC_KEYS}, want_m),
                _err(avg, want, params),
                max(_err(avg, want, [k]) for k in stats))
    assert worst >= 1e-4, worst


def _check_state(got: dict, ref: dict, bar: float = 1e-9) -> None:
    params, stats = _params_and_stats(ref)
    assert _err(got, ref, params) <= bar
    for k in stats:
        assert _err(got, ref, [k]) <= bar, k


def test_dp_accumulated_step_matches_single_device(dp):
    """``train_step_accum`` with A=2 micro-batches of 4 rows, 2 per
    rank."""
    ref = dp["ranks"][0]["accum_ref"]
    for rank in dp["ranks"]:
        _check_state(rank["accum"]["sd"], ref["sd"])
        torch.testing.assert_close(rank["accum"]["metrics"], ref["metrics"],
                                   rtol=1e-9, atol=0)


def test_dp_epoch_over_sharded_loaders_matches_single_device(dp):
    """``run_train_and_eval_epoch_async`` over ``shard_loader`` loaders: 7
    training images at B=4 (a full batch and a remainder of 3, split 2
    and 1) and 3 validation images (a remainder of 3)."""
    ref = dp["ranks"][0]["epoch_ref"]
    for rank in dp["ranks"]:
        got = rank["epoch"]
        _check_state(got["sd"], ref["sd"])
        for t in ("tt", "vt"):
            torch.testing.assert_close(got[t], ref[t], rtol=1e-9, atol=0)


def test_replicate_state_broadcasts_rank_zero(dp):
    """Rank 1's weights and optimizer moments, perturbed by 1, come back
    to rank 0's values."""
    r0, r1 = (r["replicate"] for r in dp["ranks"])
    for k, v in r0["before"].items():
        assert torch.equal(r0["after"][k], v), k
        assert torch.equal(r1["after"][k], v), k


def test_mesh_and_multihost_input(dp):
    """``create_mesh``'s shape and names; ``process_local_slice`` as the
    JAX package's ceil partition; ``global_batch_from_local`` keeps each
    rank's rows and has the global shape."""
    for rank, res in enumerate(dp["ranks"]):
        assert res["mesh"] == ((2,), ("data",))
        assert res["mesh2"] == ((2, 1), ("data", "spatial"))
        assert res["slice"] == ((0, 5), (5, 10))[rank]
        assert res["global"] == ((B, 1, S, S), True)


def test_mesh_and_multihost_input_at_world_one(tmp_path):
    """One gloo rank in this process: the mesh's shape and names, and
    ``global_batch_from_local``/``process_local_slice`` as on one JAX
    process (local == global); the ceil partition of 5 rows over 4
    ranks."""
    from segtpu_torch.core.dist import (create_mesh, init_process_group,
                                        process_rows)
    from segtpu_torch.parallel import (global_batch_from_local,
                                       process_local_slice)
    assert process_local_slice(100) == slice(0, 100)   # no group yet
    assert [process_rows(5, 4, r) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 5), slice(5, 5)]
    init_process_group(f"file://{tmp_path}/rdzv", 1, 0, device="cpu")
    try:
        mesh = create_mesh(device="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == ((1,), ("data",))
        local = np.random.default_rng(0).random((16, 1, 8, 8)).astype(
            np.float32)
        arr = global_batch_from_local(local, mesh)
        assert tuple(arr.shape) == (16, 1, 8, 8)
        np.testing.assert_array_equal(arr.to_local().numpy(), local)
        assert process_local_slice(100) == slice(0, 100)
    finally:
        torch.distributed.destroy_process_group()


def test_uneven_and_empty_ranks_match_single_device(tmp_path):
    """4 ranks, 9 images at B=5: the full batch puts 2, 2, 1 and 0 rows on
    the ranks, the remainder of 4 one each; the epoch equals the
    single-device one."""
    r = np.random.default_rng(1)
    ex = r.uniform(0, 1, (9, S, S, 1))
    model = get_engine({"backbone": "resnet_tiny", **CFG},
                       device="cpu").build_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save({"state_dict": model.state_dict(), "ex": _nchw(ex),
                "ey": _nchw((ex > 0.6).astype(np.float64)), "batch": 5,
                "lr": LR, "wd": WD, "cfg": CFG}, tmp_path / "inputs.pt")
    ranks = launch("uneven", 4, tmp_path)
    ref = ranks[0]["ref"]
    for rank in ranks:
        _check_state(rank["sd"], ref["sd"])
        for k in METRIC_KEYS:
            assert abs(rank["metrics"][k] - ref["metrics"][k]) <= \
                1e-9 * max(1.0, abs(ref["metrics"][k])), k
