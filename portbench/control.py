"""Readings that set a cell's limits: the program's, the control's and
the faults', over many seeds in one process, at the cell's own sizes.

    python3 portbench/control.py --workload r34att.train.b8 \
        --mode program --seeds 11,12,13 --seconds 2

``--mode``:

- ``program``: the run's own path (set-up, a window of ``--seconds``,
  the reference after it); the numbers a sound run reads;
- ``control``: the reference in the program's place, its convolutions'
  operands rounded to float8 e4m3 (``reference/fp8.py``), the precision
  below the configuration's bfloat16;
- ``unchanged``, ``half_batch`` and ``altered``: the reference in the
  program's place with the fault planted: a step that leaves the state
  as it was; each step on half of its batch, the loss the mean over that
  half; the validation pass's answer for one image inverted (its logits
  negated) where it is produced.

Prints one JSON line per seed with every number the check reads (the
limits file chooses which are compared). Needs a CUDA device, as the
benchmark does; ``--device cpu`` rehearses it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MODES = ("program", "control", "unchanged", "half_batch", "altered")


def reading(cell, seed: int, mode: str, seconds: float, device) -> dict:
    import torch

    from portbench.reference.fp8 import quantize_e4m3
    from portbench.trace import Tracer
    mix = cell.kind(cell.config, cell.traffic, seed, torch.device(device))
    if mode == "program":
        mix.setup()
        mix.window(seconds, Tracer(device), 0)
        mix.free()
        return mix.reference_numbers()
    mix.make_inputs()
    if mode == "control":
        return mix.reference_numbers(quantize=quantize_e4m3)
    return mix.reference_numbers(fault=mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench.spec import load_cell
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = reading(cell, seed, args.mode, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
