"""Rehearsal sizes for the CPU tests: every cell at 64², small batches,
float32 where a test needs the program to agree with the reference to
rounding, so that a planted fault stands out."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

IMAGES = {"min_blobs": 1, "max_blobs": 5, "min_radius": 2, "max_radius": 8,
          "fg_low": 0.5, "fg_high": 0.9, "bg_low": 0.05, "bg_high": 0.3,
          "noise": 0.08}
# one training step an epoch (4 of 6 images, B=4), two epochs a fold
SMALL_TRAIN = {"image_size": 64, "batch_size": 4, "n_images": 6, "n_val": 2,
               "epochs": 2, "trace_units": 1, "images": IMAGES}
WORKLOADS = ("r34att.train.b8", "r50plain.train.b8")
SEED = 2 ** 31 + 17


def load_small(workload: str, dtype: str = "float32", root=ROOT):
    """The cell at the rehearsal sizes, in ``dtype``."""
    from portbench.spec import load_cell
    return load_cell(root, workload, traffic=SMALL_TRAIN,
                     config={"dtype": dtype})
