"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload r34att.train.b8 --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` profiles the first ``trace_units`` units (folds)
of the window and reports the per-layer metrics, the device's busy and
window seconds and a breakdown. Either way the run then checks
the program's outputs against the plain reference and prints each
compared number beside its limit, last on standard error and last in
the result line (``checks``). The last line of standard output is the
result, one JSON object.

Exit codes: 0 with a result line; 2 without a CUDA device (or fewer than
the cell asks for), printing no result; 3 when a module of JAX or of the
JAX package is loaded once the window has closed, printing no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> Dict:
    """The result dict of one run of ``cell`` (``spec.Cell``), its
    ``checks`` last."""
    import torch

    from portbench import check, counts
    from portbench.trace import Tracer, breakdown

    dev = torch.device(device)
    mix = cell.kind(cell.config, cell.traffic, seed, dev)
    t_mix = time.perf_counter()
    mix.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_setup = time.perf_counter()
    setup_s = t_setup - t0
    print(f"portbench: set-up {setup_s:.2f} s: {t_mix - t0:.2f} s to the "
          f"traffic, {t_setup - t_mix:.2f} s in its set-up",
          file=sys.stderr, flush=True)
    op_names = sorted({op for r in cell.readers.values()
                       for op in getattr(r, "ops", ())})
    tracer = Tracer(dev, op_names)
    units = int(cell.traffic["trace_units"]) if trace else 0
    res = mix.window(float(seconds), tracer, units)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = SimpleNamespace(**mix.context(), cell=cell.name,
                          model_cfg=cell.config, traffic=cell.traffic)
    mix.free()
    numbers = mix.reference_numbers()
    correct, checks = check.judge(numbers, cell.limits)
    correct = correct and res["failed"] == 0
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"]}
    if not trace:
        values = dict(res["metrics"], setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        tr = tracer.reduce()
        ctx.trace = tr
        ctx.forward_flops = 2 * counts.forward_macs(
            cell.config, int(cell.traffic["image_size"]))
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        if tr is not None:
            dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = breakdown(tr)
    out["device"] = dev_info
    out["checks"] = checks
    return out


def _card_line() -> Optional[str]:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import check, importcheck
    from portbench.spec import load_cell
    cell = load_cell(ROOT, args.workload)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this host has {have}", file=sys.stderr)
        return 2
    card = _card_line()
    print(f"portbench: {args.workload} seed {args.seed} on {card} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})",
          file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    faults = importcheck.report()
    if faults:
        print(f"portbench: no result: {'; '.join(faults)}", file=sys.stderr)
        return 3
    check.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
