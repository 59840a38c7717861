"""The three ported experiment drivers run through the CLI, each as its own
process, on one synthetic directory of TIFFs, timed on the host clock.

    python -m segtpu_torch.tools.experiment_runs [--device cuda]
        [--images 28] [--out PATH]

Writes ``--images`` W pairs at a raw 520×696 with the port's
``make_synthetic_dataset`` into a temporary directory, then runs
``python -m segtpu_torch.cli --experiment <name> --quick`` for
model_configuration, augmentation_amount and loss_function, in that order,
and prints one JSON line: each run's seconds (process start to exit,
imports and the data's decode included), its exit code and the JSON
artefacts it wrote, beside the device's name. A run that fails fails the
tool. Writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from segtpu_torch import resolve_device
from segtpu_torch.data import make_synthetic_dataset
from segtpu_torch.tools import device_label

EXPERIMENTS = ("model_configuration", "augmentation_amount", "loss_function")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--images", type=int, default=28)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    runs = []
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-runs-") as root:
        data = os.path.join(root, "data")
        make_synthetic_dataset(data, n_images=args.images, image_type="W",
                               raw_size=(520, 696), seed=0)
        for exp in EXPERIMENTS:
            save = os.path.join(root, exp)
            cmd = [sys.executable, "-m", "segtpu_torch.cli", "--experiment",
                   exp, "--quick", "--data-dir", data, "--save-root", save,
                   "--device", dev.type]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            written = sorted(f for _, _, fs in os.walk(save) for f in fs)
            runs.append(dict(experiment=exp, seconds=seconds,
                             returncode=proc.returncode, artefacts=written,
                             last_lines=proc.stdout.splitlines()[-3:]))
            print(f"{exp}: exit {proc.returncode} in {seconds:.1f} s",
                  flush=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
    res = dict(images=args.images, raw_size=[520, 696], runs=runs,
               **{**device_label(dev), "clock": "host s, process start "
                  "to exit"})
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    if any(r["returncode"] != 0 for r in runs):
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
