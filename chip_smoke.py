#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``segtpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs CUDA and exits non-zero without
it, or when any phase fails:

1. device: prints ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles ``segtpu_torch/csrc/*.cu`` for sm_90a into
   ``build/segtpu_torch/`` (one nvcc per source, started together),
   prints each entry function's registers and spills, and fails unless
   every source has a bf16 tensor-core instantiation and none of them
   spills or has its warpgroup serialised around ``wgmma``;
3. kernels: each kernel against its plain PyTorch version, in f32 and
   bf16, with kernel, plain and library times from CUDA events, the
   least time the card could take (bound), the achieved TFLOP/s of the
   function's operations and the bound's share of the kernel's time:
   the gate and the upsample at every shape the flagship forward (B=16,
   512²) gives them (the gate also against the model's own unfused gate,
   ``composition_ms``), the upsample also at the two levels the forward
   does not fuse (``"serving": false``, out of the sums), the
   conv3×3+BN+ReLU and the fused decoder pair at the flagship's four
   decoder blocks (B=16);
4. serving, attention model: the flagship resnet34 attention U-Net in bf16
   answers 3 ``predict_proba`` requests of 16 images of 512², through the
   attention-gate kernel (4 launches per forward), held against the same
   weights run without kernels in f32; the forward with the kernels and
   without, alternated; a profiled forward (device busy share, the port
   kernels' share, the top five kernels); and the host time of the four
   gates' BatchNorm folds, fresh and cached;
5. serving, no-attention model: the same, through the upsample+concat
   kernel (2 launches per forward at B=16);
6. benches: ``segtpu_torch.tools.kernel_bench`` and ``fused_block_bench``
   through ``main(argv)`` at their full widths (B=8, bf16), the only paths
   that run the conv and pair kernels; each wrapper must have launched
   exactly as often as the bench called it, and each case must agree with
   its plain version;
7. one JSON line ``{"kernels": [...]}``, then the card line, then the
   result line ``{"ok": true, "device": {...}}``.

The weights are random, made from a fixed seed; the BatchNorm running
statistics come from one batch of random images, then jittered.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH, SIZE, REQUESTS = 16, 512, 3
# Attention gates of one flagship forward: (Cg, Cx, F, H=W) at B=16.
GATE_SHAPES = ((256, 256, 128, 32), (128, 128, 64, 64), (64, 64, 32, 128),
               (32, 64, 32, 256))
# Fused upsample levels of one flagship forward at B=16 (levels 3 and 2):
# (Cin, Co, Cs, H=W of x).
UPSAMPLE_SHAPES = ((256, 128, 128, 32), (128, 64, 64, 64))
# The levels it does not fuse at B=16 (4 and 1), timed for the routing
# thresholds (``fuse_min_cin``, ``fuse_min_work``) and kept out of the sums.
UPSAMPLE_OFF_PATH = ((512, 256, 256, 16), (64, 32, 64, 128))
# Decoder blocks of the flagship at B=16, 512², levels 4..1: (H=W, Cin,
# Cout) of the pair, whose first conv is also the conv3x3 case.
DECODER_SHAPES = ((32, 512, 256), (64, 256, 128), (128, 128, 64),
                  (256, 96, 32))
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and dense operations/s
# by input type (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32: kernel and plain version sum the same f32 products in other orders
# (at most 9·512 = 4608 of them, the conv at level 4; the pair's conv 2
# adds 2304 more on an f32 intermediate): a relative error of about
# √K·2^-24 ≈ 4e-6 of the output's scale. 1e-4 of that scale is far above
# this reassociation noise and far below any indexing, tap or halo error.
TOL_F32 = 1e-4
# bf16: the kernel rounds its f32 result to bf16 once (half an ulp,
# 2^-8 of the value); 2^-7 of the output's scale leaves room for the
# summation order. The reference is the plain version in f32 on the same
# bf16-rounded inputs. (The Pallas kernel also rounds the hidden map and
# alpha to bf16; this kernel keeps both in f32, so it is the closer one.)
# The conv3x3 is held the same way. The pair rounds its intermediate to
# bf16 before conv 2, as the reference function does, so its reference is
# the plain version with that rounding and conv 2 in f32: the kernel's and
# the plain version's f32 sums differ by reassociation, which can flip the
# bf16 rounding of an intermediate element (one ulp, ≤ 2^-7 of it) at a
# few elements; conv 2 (K = 9·C ≤ 2304, weights ~1/√K) carries a flip
# into an output at about 2^-7/√K of its scale, so 2^-7 holds as well.
TOL_BF16 = 2.0 ** -7
# The benches compare with the plain version in bf16: both round the final
# value, so they may sit one ulp (≤ 2^-7 of the value) apart before any
# of the flips above: 2^-6 of the output's scale.
TOL_BENCH_BF16 = 2.0 ** -6
# Serving: bf16 model vs the f32 model without kernels (TF32 off). bf16
# keeps 8 significant bits through ~70 layers, and the head sums 16
# channels whose terms largely cancel, so a logit's error is a larger
# share of the logit than 2^-8 (5.7% of max|logit| for this model at 64²
# on the CPU): logits within 10% of their largest magnitude,
# probabilities within 0.05.
TOL_LOGITS_REL, TOL_PROBS = 1e-1, 5e-2
# f32 model with kernels vs without: reassociation only.
TOL_MODEL_F32_REL = 1e-4

FAILURES: list = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn()`` from CUDA events around each call,
    after 3 warm-up calls; ``flush`` (a >50 MB tensor) is overwritten
    before each call so every call starts with a cold L2, as in the
    model, where each kernel's inputs were written by earlier layers."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_ms(fn, iters: int = 20) -> float:
    """Mean host-clock time of ``fn()`` up to a synchronised device,
    after 3 warm-up calls: for host-bound work (many tiny launches, or
    none), which CUDA events between idle points do not see."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(nbytes: float, ops: float, dtype) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return card


def _entry_label(line: str) -> str:
    """``kernel<template arguments>`` from ptxas's "Compiling entry
    function '<mangled name>'" line, e.g. ``pair_bf16_kernel<8,16,2,4,4,16,
    3>`` or ``conv_f32_kernel<f,64>``."""
    mangled = line.split("'")[1] if "'" in line else line
    # a name is mangled as <length><name>: try every digit run's suffixes
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and name[:1].isalpha():
            rest = mangled[end + len(name):]
            args = re.findall(r"Li(\d+)E|(13__nv_bfloat16)|^I(f)", rest)
            args = ["bf16" if b else n or f for n, b, f in args]
            return f"{name}<{','.join(args)}>"
    return mangled


def phase_build() -> None:
    """Compile every kernel; print each entry function's registers and
    spills from ``-Xptxas -v``, and fail unless each source has a bf16
    tensor-core instantiation (``*_bf16_kernel``/``*_wgmma_kernel``) and
    none of them spills, or if ptxas serialised a warpgroup around its
    ``wgmma`` products (note C7519, "warpgroup.arrive is injected")."""
    from segtpu_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)
    spills, serialised = {}, 0
    for name, info in built.items():
        serialised += info["log"].count("(C7519)")
        print(f"  {name}: {info['seconds']:.1f} s")
        entry = name
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                entry = _entry_label(line)
            elif "registers" in line or "spill" in line or "warning" in line:
                print(f"    {entry}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spills.setdefault(name, {})[entry] = int(m.group(1))
    for name in built:
        tc = {k: v for k, v in spills.get(name, {}).items()
              if re.search(r"_(bf16|wgmma)_kernel<", k)}
        check(len(tc) > 0 and not any(tc.values()),
              f"build: {name}: 0 spill bytes in its {len(tc)} bf16 "
              f"tensor-core instantiations ({tc})")
    if built:
        check(serialised == 0, f"build: {serialised} wgmma serialisation "
              "notes (C7519)")


def _gate_case(shape, dtype, gen, device):
    from segtpu_torch.kernels.attention_gate import attention_gate_plain
    cg, cx, f, hw = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    g, x = r(BATCH, hw, hw, cg), r(BATCH, hw, hw, cx)
    ag, ax = r(cg, f) / cg ** 0.5, r(cx, f) / cx ** 0.5
    bh, apsi = r(f) * 0.1, r(f) / f ** 0.5
    bpsi = torch.full((1,), 0.1, device=device)
    args = [t.to(dtype) for t in (g, x, ag, ax)] + [bh, apsi.to(dtype), bpsi]
    ref = attention_gate_plain(*[t.float() for t in args])
    m = BATCH * hw * hw
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (m * (cg + 2 * cx) + (cg + cx + 1) * f) + 4 * (f + 1)
    ops = 2 * m * f * (cg + cx) + 3 * m * f + m * cx

    # the model's own unfused gate (no single call computes the gate):
    # 1x1 convs, BatchNorms, ReLU, sigmoid and product on the channels_last
    # NCHW views of g and x, random weights
    from segtpu_torch.models.attention import AttentionGate
    gate = AttentionGate(cg, cx, f, device=device, dtype=dtype).eval()
    gl, xl = args[0].permute(0, 3, 1, 2), args[1].permute(0, 3, 1, 2)

    def composition():
        with torch.inference_mode():
            return gate(gl, xl, fused=False)
    return args, ref, nbytes, ops, None, {"composition_ms": composition}


def _upsample_case(shape, dtype, gen, device):
    import torch.nn.functional as F
    from segtpu_torch.kernels.fused_conv import upsample2x_concat_plain
    cin, co, cs, hw = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x, skip = r(BATCH, hw, hw, cin), r(BATCH, 2 * hw, 2 * hw, cs)
    wv = r(cin, 2, 2, co) / cin ** 0.5
    b = r(co) * 0.1
    args = [x.to(dtype), wv.to(dtype), b, skip.to(dtype)]
    ref = upsample2x_concat_plain(*[t.float() for t in args])
    m = BATCH * hw * hw
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (m * cin + 4 * m * cs + 4 * m * (cs + co)
                   + cin * 4 * co) + 4 * co
    ops = 2 * m * cin * 4 * co + 4 * m * co

    # library yardstick: the unfused model's own two calls, in NCHW views
    # of channels_last tensors
    xl, skl = args[0].permute(0, 3, 1, 2), args[3].permute(0, 3, 1, 2)
    wl, bl = args[1].permute(0, 3, 1, 2), b.to(dtype)

    def library():
        return torch.cat([skl, F.conv_transpose2d(xl, wl, bl, stride=2)], 1)
    return args, ref, nbytes, ops, library, {}


def _conv_params(r, rand, dtype, cin, cout):
    """w (3,3,Cin,Cout) in ``dtype``, scaled so the sums are O(1), and
    f32 scale and bias (Cout,)."""
    w = r(3, 3, cin, cout) / (3 * cin ** 0.5)
    return [w.to(dtype), 0.5 + rand(cout), r(cout) * 0.1]


def _folded_conv(w, scale, bias):
    """The library yardstick of one conv3x3+BN+ReLU, as a function of an
    NCHW input: ``F.conv2d`` in the working dtype on channels_last
    tensors, scale folded into the weights (outside the timed call),
    bias, ReLU."""
    import torch.nn.functional as F
    wl = (w.float() * scale).permute(3, 2, 0, 1).to(w.dtype).contiguous(
        memory_format=torch.channels_last)
    bl = bias.to(w.dtype)
    return lambda inp: torch.relu_(F.conv2d(inp, wl, bl, padding=1))


def _conv_case(shape, dtype, gen, device):
    from segtpu_torch.kernels.fused_conv import conv3x3_bn_relu_plain
    hw, cin, cout = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)
    args = [r(BATCH, hw, hw, cin).to(dtype)] + _conv_params(
        r, rand, dtype, cin, cout)
    ref = conv3x3_bn_relu_plain(*[t.float() for t in args])
    m = BATCH * hw * hw
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (m * cin + 9 * cin * cout + m * cout) + 4 * 2 * cout
    ops = 2 * m * 9 * cin * cout
    conv, xl = _folded_conv(*args[1:]), args[0].permute(0, 3, 1, 2)
    return args, ref, nbytes, ops, lambda: conv(xl), {}


def _pair_case(shape, dtype, gen, device):
    from segtpu_torch.kernels.fused_conv import conv3x3_bn_relu_plain
    hw, cin, c = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)
    x = r(BATCH, hw, hw, cin).to(dtype)
    first = _conv_params(r, rand, dtype, cin, c)
    second = _conv_params(r, rand, dtype, c, c)
    args = [x] + first + second
    # the reference function, its intermediate rounded to the I/O type,
    # with conv 2 and the result in f32
    mid = conv3x3_bn_relu_plain(x, *first)
    ref = conv3x3_bn_relu_plain(mid.float(), *[t.float() for t in second])
    del mid
    m = BATCH * hw * hw
    es = torch.finfo(dtype).bits // 8
    nbytes = (es * (m * cin + 9 * cin * c + 9 * c * c + m * c)
              + 4 * 4 * c)
    ops = 2 * m * 9 * c * (cin + c)
    conv1, conv2 = _folded_conv(*first), _folded_conv(*second)
    xl = x.permute(0, 3, 1, 2)
    return args, ref, nbytes, ops, lambda: conv2(conv1(xl)), {}


def phase_kernels(device="cuda") -> dict:
    """Each kernel vs its plain version at the flagship shapes, f32 and
    bf16. Returns {name: [per-shape records]} of the bf16 runs; a record's
    ``serving`` says whether the flagship forward runs that shape."""
    from segtpu_torch.kernels.attention_gate import (attention_gate,
                                                     attention_gate_plain)
    from segtpu_torch.kernels.fused_block import (conv_pair_bn_relu,
                                                  conv_pair_bn_relu_plain)
    from segtpu_torch.kernels.fused_conv import (conv3x3_bn_relu,
                                                 conv3x3_bn_relu_plain,
                                                 upsample2x_concat,
                                                 upsample2x_concat_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    table = (("attention_gate", attention_gate, attention_gate_plain,
              _gate_case, GATE_SHAPES),
             ("upsample2x_concat", upsample2x_concat,
              upsample2x_concat_plain, _upsample_case,
              UPSAMPLE_SHAPES + UPSAMPLE_OFF_PATH),
             ("conv3x3_bn_relu", conv3x3_bn_relu, conv3x3_bn_relu_plain,
              _conv_case, DECODER_SHAPES),
             ("conv_pair_bn_relu", conv_pair_bn_relu,
              conv_pair_bn_relu_plain, _pair_case, DECODER_SHAPES))
    records = {name: [] for name, *_ in table}
    for name, kernel, plain, case, shapes in table:
        for dtype in (torch.float32, torch.bfloat16):
            tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
            for shape in shapes:
                args, ref, nbytes, ops, library, extra = case(
                    shape, dtype, gen, device)
                out = kernel(*args)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                tol = tol_rel * max(1.0, ref.abs().max().item())
                dt = str(dtype).removeprefix("torch.")
                check(err <= tol and out.dtype == dtype,
                      f"{name} {dt} {shape}: max_abs_err {err:.3g} "
                      f"(tol {tol:.3g})")
                rec = dict(shape=list(shape), dtype=dt, max_abs_err=err,
                           ms=time_ms(lambda: kernel(*args), flush=flush),
                           plain_ms=time_ms(lambda: plain(*args),
                                            flush=flush),
                           library_ms=(time_ms(library, flush=flush)
                                       if library else None),
                           serving=not (name == "upsample2x_concat"
                                        and shape in UPSAMPLE_OFF_PATH),
                           **{k: time_ms(fn, flush=flush)
                              for k, fn in extra.items()})
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
                # achieved rate of the function's own operations, and the
                # share of the least time the kernel reaches
                rec["tflops"] = ops / rec["ms"] * 1e-9
                rec["bound_share"] = rec["bound_ms"] / rec["ms"]
                print("  " + json.dumps(rec), flush=True)
                if dtype == torch.bfloat16:
                    records[name].append(rec)
                del args, ref, library, extra
    return records


def _randomized_flagship(use_attention: bool, device="cuda", batch=4,
                         size=SIZE):
    """The f32 flagship model with weights from the seeded generator and
    BatchNorm running statistics set by one batch of random images
    (momentum 1), then jittered, so the folds see non-trivial values."""
    from segtpu_torch.models.unet import UNetWithBackbone
    torch.manual_seed(SEED)
    model = UNetWithBackbone(backbone="resnet34",
                             use_attention=use_attention, device=device)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    model.train()
    with torch.no_grad():
        model(torch.rand(batch, 1, size, size, generator=gen, device=device)
              .contiguous(memory_format=torch.channels_last))
        for bn in bns:
            bn.momentum = 0.1
            n = bn.num_features
            bn.running_mean.add_(0.05 * bn.running_var.sqrt() * torch.randn(
                n, generator=gen, device=device))
            bn.running_var.mul_(0.9 + 0.2 * torch.rand(
                n, generator=gen, device=device))
    return model.eval()


def _device_batch(model, images, device):
    """(N,H,W) numpy → the model's (N,1,H,W) channels_last input."""
    return (torch.from_numpy(images[..., None]).to(device)
            .to(next(model.parameters()).dtype).permute(0, 3, 1, 2)
            .contiguous(memory_format=torch.channels_last))


# Forward timing: turns of (with kernels, without), each 5 timed forwards;
# the medians are reported, so a slow spell of the shared host or the card
# falls on both.
FORWARD_TURNS = 5
# The port's kernels a serving forward can run, by the names the profiler
# shows (the tensor-core and the CUDA-core kernel of each source).
PORT_KERNELS = ("gate_bf16_kernel", "attention_gate_kernel",
                "upsample_bf16_kernel", "upsample2x_concat_kernel")


def _forward_ms(model, x, use_kernels) -> tuple:
    """(median ms with kernels, median ms without, both lists) of the
    forward on x, from FORWARD_TURNS alternated turns."""
    on, off = [], []
    with torch.inference_mode():
        for _ in range(FORWARD_TURNS):
            for flag, times in ((True, on), (False, off)):
                use_kernels(model, flag)
                times.append(time_ms(lambda: model(x), iters=5))
    return statistics.median(on), statistics.median(off), on, off


def _device_profile(model, x, forwards: int = 3) -> dict:
    """Under ``torch.profiler`` (CUDA activity), ``forwards`` forwards
    back to back: the share of their event time in which the device ran
    a kernel or copy, the port's kernels' ms per forward and share of
    that busy time, and the five kernels with the most device time, ms
    per forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(forwards):
                model(x)
            end.record()
            end.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    port = sum(t for n, t in by_name.items()
               if any(k in n for k in PORT_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(profile_busy_share=busy / start.elapsed_time(end),
                profile_port_kernels_ms=port / forwards,
                profile_port_kernels_share=port / max(busy, 1e-9),
                profile_top=[[n[:80], t / forwards] for n, t in top])


def _logits(model, images, device="cuda") -> torch.Tensor:
    with torch.inference_mode():
        return model(_device_batch(model, images, device)).float()


def phase_serving(use_attention: bool, device="cuda", batch=BATCH,
                  size=SIZE, requests=REQUESTS) -> dict:
    """3 predict_proba requests through the bf16 flagship with its kernel,
    the launches they made, img/s with the kernel and without, and the
    results against the f32 model without kernels."""
    from segtpu_torch.infer.predict import predict_proba
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    kernel = "attention_gate" if use_attention else "upsample2x_concat"
    per_forward = 4 if use_attention else 2
    label = "attention" if use_attention else "no-attention"
    rng = np.random.default_rng(SEED)
    reqs = [rng.uniform(0, 1, (batch, size, size)).astype(np.float32)
            for _ in range(requests)]

    ref32 = _randomized_flagship(use_attention, device, size=size)
    model = copy.deepcopy(ref32).to(torch.bfloat16)

    def use_kernels(m, on: bool):
        m.fuse_gate = on
        m.fuse = "kernel" if on else "none"

    def serve(m):
        """(responses, img/s, launch counts) of the requests, after one
        warm-up request that neither is timed nor counts launches."""
        predict_proba(m, reqs[0], device=device)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = [predict_proba(m, r, device=device) for r in reqs]
        ips = batch * requests / (time.perf_counter() - t0)
        return out, ips, launch_counts()

    use_kernels(model, True)
    probs, ips_on, counts = serve(model)
    check(counts[kernel] == per_forward * requests,
          f"{label}: {kernel} launched {counts[kernel]} times in "
          f"{requests} requests (want {per_forward} per forward)")
    check(all(n == 0 for k, n in counts.items() if k != kernel),
          f"{label}: no other kernel launched ({counts})")
    use_kernels(model, False)
    _, ips_off, _ = serve(model)
    x = _device_batch(model, reqs[0], device)
    fwd_on, fwd_off, fwd_on_all, fwd_off_all = _forward_ms(model, x,
                                                           use_kernels)
    use_kernels(model, True)
    try:
        profiled = _device_profile(model, x)
    except Exception as exc:
        profiled = {"profile_error": repr(exc)}
    got = profiled.get("profile_port_kernels_ms",
                       profiled.get("profile_error"))
    check(isinstance(got, float) and got > 0,
          f"{label}: the profiled forward shows {kernel}'s device time "
          f"per forward ({got})")

    use_kernels(ref32, False)
    ok_shape = all(p.shape == (batch, size, size, 1) and np.isfinite(p).all()
                   for p in probs)
    check(ok_shape, f"{label}: {requests} responses of shape "
          f"{(batch, size, size, 1)}, all finite")
    want = [predict_proba(ref32, r, device=device) for r in reqs]
    perr = max(float(np.abs(p - w).max()) for p, w in zip(probs, want))
    check(perr <= TOL_PROBS, f"{label}: bf16-with-kernel probabilities vs "
          f"f32 plain: max_abs_err {perr:.3g} (tol {TOL_PROBS})")
    use_kernels(model, True)
    lg_ref = _logits(ref32, reqs[0], device)
    scale = lg_ref.abs().max().item()
    lerr = (_logits(model, reqs[0], device) - lg_ref).abs().max().item()
    check(lerr <= TOL_LOGITS_REL * scale,
          f"{label}: bf16-with-kernel logits vs f32 plain: max_abs_err "
          f"{lerr:.3g} (tol {TOL_LOGITS_REL} x max|logit| {scale:.3g})")
    use_kernels(ref32, True)
    l32err = (_logits(ref32, reqs[0], device) - lg_ref).abs().max().item()
    check(l32err <= TOL_MODEL_F32_REL * max(1.0, scale),
          f"{label}: f32-with-kernel logits vs f32 plain: max_abs_err "
          f"{l32err:.3g}")
    folds = {}
    if use_attention:
        # the four gates' BatchNorm folds per forward: fresh (as every
        # forward did before the cache) and cached
        gates = [getattr(model, f"attention{lvl}") for lvl in (4, 3, 2, 1)]
        with torch.inference_mode():
            folds = dict(
                fold_ms_fresh=host_ms(lambda: [gt.fold() for gt in gates]),
                fold_ms_cached=host_ms(
                    lambda: [gt.folded() for gt in gates]))
    res = dict(model=label, requests=requests, batch=batch, size=size,
               launches=counts[kernel], img_per_s_kernels=ips_on,
               img_per_s_plain=ips_off, forward_ms_kernels=fwd_on,
               forward_ms_plain=fwd_off,
               forward_img_per_s_kernels=batch / fwd_on * 1e3,
               forward_img_per_s_plain=batch / fwd_off * 1e3,
               forward_ms_kernels_turns=fwd_on_all,
               forward_ms_plain_turns=fwd_off_all,
               probs_max_abs_err=perr, logits_max_abs_err=lerr,
               logits_max_abs=scale, **folds, **profiled)
    print("serving " + json.dumps(res), flush=True)
    return res


def phase_benches(device="cuda") -> dict:
    """Both bench entry points through ``main(argv)`` at their full widths,
    each with the launch counts set to 0 just before it and read just
    after: every wrapper must have launched exactly as often as the bench
    called it, and every case must agree with its plain version. Returns
    the launches of each wrapper over both benches."""
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.tools import fused_block_bench, kernel_bench
    total = {}
    for tool in (kernel_bench, fused_block_bench):
        name = tool.__name__.rsplit(".", 1)[-1]
        reset_launch_counts()
        res = tool.main(["--device", str(device)])
        counts = launch_counts()
        want = {k: res["calls"].get(k, 0) for k in counts}
        check(counts == want and sum(want.values()) > 0,
              f"{name}: launches {counts} equal the bench's calls {want}")
        for row in res["rows"]:
            print("  " + json.dumps({k: v for k, v in row.items()
                                     if k not in ("device", "clock")}))
            tol = TOL_BENCH_BF16 * max(1.0, row["ref_max_abs"])
            what = " ".join(f"{k}={row[k]}" for k in (
                "case", "h", "cin", "cout", "cskip") if k in row)
            check(row["max_abs_err"] <= tol,
                  f"{name} {what}: max_abs_err {row['max_abs_err']:.3g} "
                  f"(tol {tol:.3g})")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


KERNEL_META = {
    "attention_gate": dict(
        source="segtpu_torch/csrc/attention_gate.cu",
        replaces="segtpu/kernels/attention_gate.py:73"),
    "upsample2x_concat": dict(
        source="segtpu_torch/csrc/upsample2x_concat.cu",
        replaces="segtpu/kernels/fused_conv.py:144"),
    "conv3x3_bn_relu": dict(
        source="segtpu_torch/csrc/conv3x3_bn_relu.cu",
        replaces="segtpu/kernels/fused_conv.py:83"),
    "conv_pair_bn_relu": dict(
        source="segtpu_torch/csrc/conv_pair_bn_relu.cu",
        replaces="segtpu/kernels/fused_block.py:76"),
}


def main() -> int:
    card = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    records = phase_kernels()
    served = {"attention_gate": phase_serving(True),
              "upsample2x_concat": phase_serving(False)}
    benched = phase_benches()
    # each kernel's launches on its own main path: the serving model that
    # runs it, or the bench entry points for the conv and the pair
    launches = {"attention_gate": served["attention_gate"]["launches"],
                "upsample2x_concat": served["upsample2x_concat"]["launches"],
                "conv3x3_bn_relu": benched["conv3x3_bn_relu"],
                "conv_pair_bn_relu": benched["conv_pair_bn_relu"]}

    # per kernel: the sums over its flagship shapes (bf16)
    kernels = []
    for name, recs in records.items():
        recs = [r for r in recs if r["serving"]]
        total = lambda key: sum(r[key] for r in recs)
        lib = [r["library_ms"] for r in recs]
        kernels.append(dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=max(recs, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in lib else sum(lib)))
    print(json.dumps({"kernels": kernels}))
    print(card)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:\n  "
              + "\n  ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
