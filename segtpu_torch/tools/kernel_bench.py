"""Microbenchmark of the port's conv3×3+BN+ReLU and upsample+concat
kernels against the library composition, at the decoder shapes of the
512² flagship: the counterpart of the JAX package's
``tools/kernel_bench.py``, with its shapes and defaults (B=8, bf16).

    python -m segtpu_torch.tools.kernel_bench [--out PATH]

Each case checks the kernel against its plain version (max_abs_err), then
times, with CUDA events over back-to-back calls, the library composition
(the JAX tool's "XLA" column) and the kernel (its "Pallas" column):

- conv: ``F.conv2d`` in the working dtype on channels_last tensors, with
  the scale folded into the weights and the bias passed to it, then ReLU;
- upsample: ``F.conv_transpose2d`` + ``torch.cat``, the unfused model's
  two calls.

TF32 is turned off for cuDNN and matmul, so that the f32 plain versions
are f32. Runs on CUDA (the default; it raises without it) or, with
``--device cpu``, through the plain versions with host-clock times. Prints
one line per shape; writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.kernels.fused_conv import (conv3x3_bn_relu,
                                             conv3x3_bn_relu_plain,
                                             upsample2x_concat,
                                             upsample2x_concat_plain)
from segtpu_torch.models.convert import conv_transpose_weight
from segtpu_torch.tools import device_label, run_case, seeded

# The batch, the (H, Cin, Cout) of the 3×3 convs and the (H, Cin, Cout,
# Cskip) of the upsample+concat, as in tools/kernel_bench.py
BATCH = 8
CONV_SHAPES = [(64, 512, 256), (128, 256, 128), (256, 128, 64),
               (256, 96, 32), (256, 64, 64)]
UPS_SHAPES = [(32, 512, 256, 256), (64, 256, 128, 128), (128, 128, 64, 64),
              (128, 64, 32, 64)]


def bench_conv(b, h, c_in, c_out, dtype=torch.bfloat16, *, device="cuda",
               iters=20) -> dict:
    """One conv3×3+BN+ReLU case at (b, h, h, c_in) → c_out."""
    dev = resolve_device(device)
    randn, rand = seeded(dev)
    x = randn(b, h, h, c_in).to(dtype)
    w = (randn(3, 3, c_in, c_out) * 0.05).to(dtype)
    scale, bias = rand(c_out) + 0.5, randn(c_out) * 0.1
    calls = 0

    def kernel():
        nonlocal calls
        calls += 1
        return conv3x3_bn_relu(x, w, scale, bias)

    xl = x.permute(0, 3, 1, 2)
    wl = (w.float() * scale).permute(3, 2, 0, 1).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bl = bias.to(dtype)
    rec = dict(case="conv3x3", b=b, h=h, cin=c_in, cout=c_out,
               dtype=str(dtype).removeprefix("torch."), **device_label(dev))
    rec.update(run_case(
        kernel, lambda: torch.relu_(F.conv2d(xl, wl, bl, padding=1)),
        lambda: conv3x3_bn_relu_plain(x, w, scale, bias), dev, iters))
    rec["calls"] = {"conv3x3_bn_relu": calls}
    print(f"conv3x3 b{b} {h}x{h} {c_in}->{c_out}: "
          f"library {rec['library_ms']:.3f} ms  "
          f"kernel {rec['kernel_ms']:.3f} ms  "
          f"ratio {rec['kernel_ms'] / rec['library_ms']:.2f}x  "
          f"max_abs_err {rec['max_abs_err']:.3g}", flush=True)
    return rec


def bench_ups(b, h, c_in, c_out, c_skip, dtype=torch.bfloat16, *,
              device="cuda", iters=20) -> dict:
    """One upsample+concat case: x (b, h, h, c_in), a flax (2,2,c_in,c_out)
    kernel moved to the torch layout by ``conv_transpose_weight`` (the tap
    flip) and viewed NHWC, skip (b, 2h, 2h, c_skip)."""
    dev = resolve_device(device)
    randn, _ = seeded(dev)
    x = randn(b, h, h, c_in).to(dtype)
    skip = randn(b, 2 * h, 2 * h, c_skip).to(dtype)
    k = np.random.default_rng(0).normal(
        size=(2, 2, c_in, c_out)).astype(np.float32) * 0.1
    wv = (torch.from_numpy(conv_transpose_weight(k).copy())
          .permute(0, 2, 3, 1).contiguous().to(dev, dtype))
    bias = randn(c_out) * 0.1
    calls = 0

    def kernel():
        nonlocal calls
        calls += 1
        return upsample2x_concat(x, wv, bias, skip)

    xl, skl = x.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2)
    wl, bl = wv.permute(0, 3, 1, 2), bias.to(dtype)
    rec = dict(case="upsample2x_concat", b=b, h=h, cin=c_in, cout=c_out,
               cskip=c_skip, dtype=str(dtype).removeprefix("torch."),
               **device_label(dev))
    rec.update(run_case(
        kernel,
        lambda: torch.cat([skl, F.conv_transpose2d(xl, wl, bl, stride=2)], 1),
        lambda: upsample2x_concat_plain(x, wv, bias, skip), dev, iters))
    rec["calls"] = {"upsample2x_concat": calls}
    print(f"ups2x+cat b{b} {h}->{2 * h} {c_in}->{c_out}+{c_skip}: "
          f"library {rec['library_ms']:.3f} ms  "
          f"kernel {rec['kernel_ms']:.3f} ms  "
          f"ratio {rec['kernel_ms'] / rec['library_ms']:.2f}x  "
          f"max_abs_err {rec['max_abs_err']:.3g}", flush=True)
    return rec


def main(argv=None) -> dict:
    """Run every case; returns {"rows": [...], "calls": {wrapper: n}},
    ``calls`` being how many times the bench called each kernel wrapper."""
    ap = argparse.ArgumentParser(
        prog="python -m segtpu_torch.tools.kernel_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the results here as JSON (nothing is "
                         "written without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"kernel_bench: {device_label(dev)}, bf16, TF32 off", flush=True)
    print("== decoder conv shapes (512² input flagship) ==")
    rows = [bench_conv(BATCH, h, cin, cout, device=dev)
            for h, cin, cout in CONV_SHAPES]
    print("== upsample+concat shapes ==")
    rows += [bench_ups(BATCH, h, cin, cout, cs, device=dev)
             for h, cin, cout, cs in UPS_SHAPES]
    calls = {}
    for row in rows:
        for name, n in row["calls"].items():
            calls[name] = calls.get(name, 0) + n
    result = {"tool": "kernel_bench", "bs": BATCH, "rows": rows,
              "calls": calls}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
