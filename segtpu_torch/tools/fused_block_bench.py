"""Microbenchmark of the port's fused decoder-pair kernel
(``conv_pair_bn_relu``) against the library composition, at the four
decoder pairs of the 512² resnet34 flagship: the counterpart of the JAX
package's ``tools/fused_block_bench.py``, with its shapes and defaults
(B=8, bf16).

    python -m segtpu_torch.tools.fused_block_bench [--bs 8] [--out PATH]

Each shape checks the kernel against its plain version (rel_err =
max_abs_err / max|plain|), then times, with CUDA events over back-to-back
calls, the library composition (the JAX tool's "XLA" column: two
``F.conv2d`` calls in the working dtype on channels_last tensors, scale
folded into the weights, bias, ReLU) and the kernel. TF32 is turned off
for cuDNN and matmul. Runs on CUDA (the default; it raises without it)
or, with ``--device cpu``, through the plain version with host-clock
times. Prints one line per implementation and shape and a summary table;
writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.kernels.fused_block import (conv_pair_bn_relu,
                                              conv_pair_bn_relu_plain,
                                              pair_tile)
from segtpu_torch.tools import device_label, run_case, seeded

# (H, Cin, Cout): 512² flagship decoder conv pairs, level 4..1
SHAPES = [(32, 512, 256), (64, 256, 128), (128, 128, 64), (256, 96, 32)]


def bench_pair(bs, h, cin, cout, dtype=torch.bfloat16, *, device="cuda",
               iters=20) -> dict:
    """One decoder pair at (bs, h, h, cin) → cout → cout."""
    dev = resolve_device(device)
    randn, rand = seeded(dev)
    x = randn(bs, h, h, cin).to(dtype)
    w1 = (randn(3, 3, cin, cout) * 0.05).to(dtype)
    w2 = (randn(3, 3, cout, cout) * 0.05).to(dtype)
    s1, b1 = rand(cout) + 0.5, randn(cout) * 0.1
    s2, b2 = rand(cout) + 0.5, randn(cout) * 0.1
    args = (x, w1, s1, b1, w2, s2, b2)
    calls = 0

    def kernel():
        nonlocal calls
        calls += 1
        return conv_pair_bn_relu(*args)

    def fold(w, s):
        return (w.float() * s).permute(3, 2, 0, 1).to(dtype).contiguous(
            memory_format=torch.channels_last)

    xl, wl1, wl2 = x.permute(0, 3, 1, 2), fold(w1, s1), fold(w2, s2)
    bl1, bl2 = b1.to(dtype), b2.to(dtype)

    def library():
        mid = torch.relu_(F.conv2d(xl, wl1, bl1, padding=1))
        return torch.relu_(F.conv2d(mid, wl2, bl2, padding=1))

    rec = dict(h=h, cin=cin, cout=cout, bs=bs,
               dtype=str(dtype).removeprefix("torch."),
               tile=pair_tile(cout, dtype), **device_label(dev))
    rec.update(run_case(kernel, library,
                        lambda: conv_pair_bn_relu_plain(*args), dev, iters))
    rec["rel_err"] = rec["max_abs_err"] / max(1e-3, rec["ref_max_abs"])
    rec["calls"] = {"conv_pair_bn_relu": calls}
    shape = f"b{bs} {h}x{h} {cin}->{cout}"
    print(f"  library {shape}: {rec['library_ms']:.3f} ms", flush=True)
    print(f"  kernel {shape}: {rec['kernel_ms']:.3f} ms "
          f"rel_err={rec['rel_err']:.2e}", flush=True)
    return rec


def summary(rows, bs) -> None:
    print(f"\nfused decoder pair, bs={bs}, bf16")
    print(f"{'shape':<22}{'tile':>6}{'library ms':>12}{'kernel ms':>11}"
          f"{'ratio':>8}")
    for r in rows:
        sh = f"{r['h']}x{r['h']} {r['cin']}->{r['cout']}"
        tile = "x".join(map(str, r["tile"]))
        ratio = r["kernel_ms"] / r["library_ms"]
        print(f"{sh:<22}{tile:>6}{r['library_ms']:>12.3f}"
              f"{r['kernel_ms']:>11.3f}{ratio:>7.2f}x")


def main(argv=None) -> dict:
    """Run every shape; returns {"rows": [...], "calls": {wrapper: n}},
    ``calls`` being how many times the bench called the kernel wrapper."""
    ap = argparse.ArgumentParser(
        prog="python -m segtpu_torch.tools.fused_block_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the results here as JSON (nothing is "
                         "written without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"fused_block_bench: {device_label(dev)}, bf16, TF32 off",
          flush=True)
    rows = [bench_pair(args.bs, h, cin, cout, device=dev)
            for h, cin, cout in SHAPES]
    summary(rows, args.bs)
    result = {"tool": "fused_block_bench", "bs": args.bs, "rows": rows,
              "calls": {"conv_pair_bn_relu": sum(
                  r["calls"]["conv_pair_bn_relu"] for r in rows)}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
