"""The port's data-parallel fused training run (``run_training_fused``
on a mesh, ROADMAP A23) in float64 on two gloo ranks on the CPU
(``tests/torch_dist_worker.py``), where the runner calls the steps its
CUDA graphs capture on the card eagerly, with the same bookkeeping.

GSPMD's contract, which the JAX package's ``run_training_fused`` keeps
for sharded arrays: the data-parallel run equals the single-device run on
the same global batches. ``tests/test_torch_fused_run.py`` holds the f32
data-parallel run to the JAX package's fused run (which cannot run in
float64: its scan carries f32 and int32 scalars); here the float64 run is
held to the port's one-process fused run, which
``tests/test_torch_fused_run.py`` holds to the stepwise loop and that in
turn to the JAX package's float64 step.

Inputs: resnet_tiny without attention, SGD, the port's seeded initial
weights in float64, 32²; 5 training and 5 validation images at B=4, so
both remainders hold one image and rank 1's block of them is empty; the
plateau scheduler cuts unless the IoU grows by half; early stopping
(``min_delta`` 0.9, patience 2) ends the 4-epoch run after 3. Bars, and
why:

- every decision exactly equal (epochs run, LR history, best epoch,
  whether an epoch improved); the final and the best weights within
  ``tests/test_torch_parallel.py``'s float64 bar: parameters within 1e-9
  of the largest parameter, each running statistic within 1e-9 of its
  tensor's largest entry (SGD, since Adam's first step multiplies a
  gradient's rounding by lr/ε); the histories within 1e-6 of the largest
  metric of their epoch, since the port keeps its epoch totals in f32, in
  the fused run as in the stepwise loop;
- the two ranks: every run's histories and weights equal bit for bit;
- the (data 1 × spatial 2) mesh at 64² (bands of 32 rows) against the
  one-process run at 64²: the same bars;
- two controls, rank-local BatchNorm statistics and the gradients' mean
  in place of their sum, miss the weights' bar by 100× or more.
"""

import numpy as np
import pytest
import torch

from segtpu_torch.core.dist import process_rows
from segtpu_torch.train.engine import get_engine
from segtpu_torch.train.loop import _materialize
from test_torch_fused_run import _blobs
from torch_dist_worker import launch

S, B = 32, 4
CFG = {"use_attention": False, "optimizer": "sgd"}
RUN = dict(batch_size=B, num_epochs=4, lr0=1e-3,
           scheduler_params=dict(factor=0.5, patience=0, threshold=0.5,
                                 min_lr=1e-6),
           es_patience=2, es_min_delta=0.9)
BAR, HISTORY_BAR = 1e-9, 1e-6
DECISIONS = ("epochs_ran", "lr_history", "best_epoch", "best_found")


def _data(r, n_train, n_val, size):
    return [t.double() for t in (
        *_materialize(*_blobs(r, n_train, size), device="cpu"),
        *_materialize(*_blobs(r, n_val, size), device="cpu"))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (one launch)."""
    tmp = tmp_path_factory.mktemp("fused_dp")
    r = np.random.default_rng(0)
    ti, tm, vi, vm = _data(r, 5, 5, S)
    ti64, tm64, vi64, vm64 = _data(r, 6, 3, 64)
    model = get_engine({"backbone": "resnet_tiny", **CFG},
                       device="cpu").build_model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save({"state_dict": model.state_dict(), "dtype": torch.float64,
                "ti": ti, "tm": tm, "vi": vi, "vm": vm, "ti64": ti64,
                "tm64": tm64, "vi64": vi64, "vm64": vm64, "lr": RUN["lr0"],
                "wd": 1e-5, "cfg": CFG, "run": RUN, "seed": 1},
               tmp / "inputs.pt")
    # nine short runs a rank: a deadline for a hang, not a time limit
    return launch("fused_dp", 2, tmp, timeout=300)


def _weights_err(got: dict, want: dict) -> float:
    """The worse of: parameters against the largest parameter, each
    running statistic against its tensor's largest entry."""
    params = [k for k in want if want[k].is_floating_point()
              and "running" not in k]
    scale = max(float(want[k].abs().max()) for k in params)
    perr = max(float((got[k] - want[k]).abs().max()) for k in params) / scale
    serr = max(float((got[k] - want[k]).abs().max())
               / float(want[k].abs().max()) for k in want if "running" in k)
    return max(perr, serr)


def _history_err(got: dict, want: dict) -> float:
    return max(abs(g[k] - w[k]) / max(abs(v) for v in w.values())
               for key in ("train_history", "val_history")
               for g, w in zip(got[key], want[key]) for k in w)


def test_dp_fused_run_matches_the_one_process_fused_run_in_float64(runs):
    """Rank 1's blocks of both remainders are empty (the ceil partition of
    one row over two ranks), and the run is still the one-process run."""
    assert process_rows(5 % B, 2, 1) == slice(1, 1)
    got, want = runs[0]["runs"]["dp"], runs[0]["runs"]["one"]
    assert want["epochs_ran"] == 3 and want["best_found"]
    for k in DECISIONS:
        assert got[k] == want[k], (k, got[k], want[k])
    assert len(got["train_history"]) == len(got["val_history"]) == 3
    assert _history_err(got, want) <= HISTORY_BAR
    for key in ("sd", "best_sd"):
        assert got[key]["conv_final.weight"].dtype == torch.float64
        assert _weights_err(got[key], want[key]) <= BAR, key


def test_ranks_end_bit_for_bit_equal(runs):
    """Histories, decisions and the final and best weights of every run
    (the controls aside: theirs are rank-local by design)."""
    a, b = (r["digests"] for r in runs)
    for name in ("dp", "dp_again", "one", "bands", "anew"):
        assert a[name] == b[name], name


def test_second_run_reuses_the_runner_and_not_the_one_process_one(runs):
    """The run under ``with mesh:`` and the run with ``mesh=`` share one
    runner (two runs, equal results); the one-process run that follows
    under the same process group gets a runner of its own, keyed apart,
    and the mesh's runner is not run again."""
    for rank in runs:
        cache, d = rank["cache"], rank["digests"]
        assert cache["dp"]["runs"] == 2 and cache["dp"]["captures"] == 0
        assert cache["keys"] == 2 and cache["one_runs"] == 1
        assert cache["dp_runs_after"] == 2
        assert d["dp"] == d["dp_again"]


def test_a_process_group_made_anew_gets_a_runner_of_its_own(runs):
    """After ``destroy_process_group`` and a new group, a mesh of the same
    shape (whose group names repeat the old ones) keys a runner of its
    own: the cached runner, which holds the destroyed group, is not run
    again, and the new run is the first one's."""
    for rank in runs:
        anew, d = rank["cache"]["anew"], rank["digests"]
        assert anew["own_runner"] and anew["runs"] == 1, anew
        assert not anew["stale_run_again"]
        assert d["anew"] == d["dp"]


def test_bands_on_a_1x2_mesh_match_the_one_process_run(runs):
    """6 training images at B=4 (a remainder of 2) and 3 validation images
    of 64², placed [Shard(0), Shard(2)] on a (data 1 × spatial 2) mesh:
    each rank trains on bands of 32 rows."""
    r0 = runs[0]
    for k, (got, want) in r0["bands_decisions"].items():
        assert got == want, k
    assert max(r0["bands"].values()) <= BAR, r0["bands"]


@pytest.mark.parametrize("control", ["rank_local_stats", "mean_gradients"])
def test_controls_miss_the_bar(runs, control):
    r0 = runs[0]["runs"]
    err = _weights_err(r0[control]["sd"], r0["one"]["sd"])
    assert err >= 100 * BAR, err


def test_s2d_stem_takes_an_empty_batch():
    """ROADMAP C5: an empty rank's validation forward reaches the s2d stem
    with no rows, and torch's ``pixel_unshuffle`` hands an empty batch
    back unshuffled (one channel, not four); the stem takes the plain conv
    there, whose output has the s2d form's shape."""
    from segtpu_torch.models.backbones import GrayStem
    stem = GrayStem(device="cpu").eval()
    with torch.no_grad():
        assert stem(torch.zeros(0, 1, 64, 64)).shape == (0, 64, 32, 32)
        assert stem(torch.zeros(1, 1, 64, 64)).shape == (1, 64, 32, 32)
