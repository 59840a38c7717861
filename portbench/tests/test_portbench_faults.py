"""The check fails what it must: the run with its timed path broken
underneath comes out not correct, once for each fault a cell can have,
and the control (the reference computed in float8 in the program's
place) keeps its distance from the sound program. At 64² on the CPU,
against each cell's own limits; the control at 128²."""

from __future__ import annotations

import time

import pytest
import torch

from rehearsal import IMAGES, ROOT, SEED, WORKLOADS, load_small


def _run(workload):
    from portbench.run import run_cell
    return run_cell(load_small(workload), SEED + 3, 0.3, False, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_validation_answer_inverted_where_it_is_produced_is_not_correct(
        workload, monkeypatch, cpu_threads):
    from segtpu_torch.models.unet import UNetWithBackbone
    original = UNetWithBackbone.forward

    def swapped(self, *a, **kw):
        out = original(self, *a, **kw)
        if self.training:
            return out
        return torch.cat([-out[:1], out[1:]])
    monkeypatch.setattr(UNetWithBackbone, "forward", swapped)
    out = _run(workload)
    assert not out["correct"], out["checks"]
    assert out["checks"]["val_loss_gap"]["value"] \
        > out["checks"]["val_loss_gap"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        workload, monkeypatch, cpu_threads):
    from segtpu_torch.train.optim import DeviceOptimizer
    monkeypatch.setattr(DeviceOptimizer, "step",
                        lambda self, closure=None: None)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_left_out_is_not_correct(workload, monkeypatch,
                                                cpu_threads):
    from segtpu_torch.train.engine import TrainEngine
    original = TrainEngine._train_step_vec

    def half(self, state, images, masks):
        h = images.shape[0] // 2
        return original(self, state, images[:h], masks[:h])
    monkeypatch.setattr(TrainEngine, "_train_step_vec", half)
    out = _run(workload)
    assert not out["correct"], out["checks"]


# the control's size: the limits are set at 512² on the card, where the
# control reads 3.2× (r34) and 6.3× (r50) the sound program's
# ``stats_gap_median`` (PERF.md §2); at a size the CPU holds, the control
# has to keep that distance from the program in its own bfloat16
CONTROL_SIZE = {"image_size": 128, "batch_size": 8, "n_images": 16,
                "n_val": 8, "epochs": 1, "trace_units": 1, "images": IMAGES}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_float8_control_reads_three_times_the_program(workload,
                                                          cpu_threads):
    from portbench.control import reading
    from portbench.spec import load_cell
    cell = load_cell(ROOT, workload, traffic=CONTROL_SIZE)
    sound = reading(cell, SEED + 4, "program", 0.3, "cpu")
    control = reading(cell, SEED + 4, "control", 0.3, "cpu")
    assert control["stats_gap_median"] >= 3 * sound["stats_gap_median"], \
        (sound, control)
