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
7. training: one train step of ``resnet_tiny`` at 64² on the card, in
   f32 (TF32 off) and in float64, against the same step of the port on
   the CPU in float64;
   then ``segtpu_torch.api.Segmenter`` fits the flagship (resnet34,
   attention, 512², bf16 compute with f32 parameters, B=8) for 2 epochs
   on 20 synthetic images and predicts 16, through the gate kernel (4
   launches per validation and ``predict`` forward); the trained model
   with the gate kernel against the same model without it, after fit and
   after an optimizer step alone (which must bump every gate parameter's
   version and refold the gates: the BatchNorm-fold cache on the CUDA
   optimizer's path); 30 timed steps on one batch and 3 profiled ones; a
   no-attention ``Segmenter`` for 1 epoch, whose validation pass runs the
   upsample kernel, then with the upsample kernel against without it; a
   ``train {...}`` line;
8. data: a directory of TIFFs written with the port's
   ``make_synthetic_dataset`` (20 W pairs at a raw 1040×1392) and
   ``write_tiff`` (8 W pairs at 768×1024, 4 B pairs that discovery must
   skip); ``load_original_data`` pairs the 28 W files; the flagship
   ``Segmenter`` fits 1 epoch on 24 of them with 3 augmentations per
   image (96 training images, 12 steps of B=8, bf16) and validates on 4,
   then predicts all 28 from their paths. Checks (f) every file decoded
   once by the native reader (56 decodes, 0 by Pillow), bit for bit the
   pixels written; (g) ``load_canonical`` on the card against the same
   call on the CPU; (h) the augmentation on the card: originals first,
   bit for bit, N·4 frames, binary masks, each production transform's
   apply against its apply on the CPU for the same draws, and the mask
   of rot90 and vflip moved exactly as the image; (i) 4 gate launches per
   validation and predict forward, finite losses, ``predict(paths)``
   equal to ``predict`` of their canonical frames, and at the predict
   forward's batch of 28 the trained model with the gate kernel against
   the unfused gate, and each of that forward's four gate calls against
   the plain version on its inputs. A ``data {...}`` line (the reader's
   g++ build is timed apart, before the fit);
9. one JSON line ``{"kernels": [...]}``, then the card line, then the
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
# Training, check (a): one train step of resnet_tiny at 64² on the card
# in f32 (TF32 off) and in float64, each against the same step of the
# port on the CPU in float64, same weights and batch. Gradients are held
# per tensor, scaled by the tensor's largest gradient floored at 1e-2 of
# the model's largest (a tensor whose gradients all sit far below the
# rest, such as a BatchNorm shift feeding another BatchNorm, carries only
# rounding). f32: the loss and the running variances within 1e-4 of
# themselves (the port's f32 step on the CPU: 2e-7 and 5e-7), the
# gradients within 5e-2: at the bottom of the U-Net a BatchNorm normalises
# 2·4·4 pixels and its backward sums with heavy cancellation; the port's
# f32 step on the CPU sits 2.1e-2 from float64 there at one seed, cuDNN's
# 2.2e-2 at this one (decoder4.3.weight). float64: the same mathematics,
# within 1e-9 (the loss 1e-6: the metric vector is f32).
TOL_STEP_F32 = dict(loss=1e-4, running_var=1e-4, grad=5e-2)
TOL_STEP_F64 = dict(loss=1e-6, running_var=1e-9, grad=1e-9)
# Training, check (d): the trained bf16 model with the gate kernel
# against itself without it: probabilities within §2's 0.05 bar, the
# validation IoU within 0.01.
TOL_TRAIN_IOU = 1e-2
# The training run: the flagship at full width and depth, B=8 (the
# smallest batch of the JAX package's tools/train_bench.py), 16 training
# and 4 validation images of 512², 2 epochs; then 16 images predicted.
TRAIN_CONFIG = {"img_size": (SIZE, SIZE), "batch_size": 8,
                "dtype": "bfloat16", "loss_fn": "combo", "num_epochs": 2,
                "seed": SEED, "verbose": False}
TRAIN_IMAGES, VAL_IMAGES, PREDICT_IMAGES = 16, 4, 16
# The step time: the median of this many steps on one resident batch.
TIMED_STEPS = 30
# The data phase: (pairs, raw (H, W)) of the two W shape groups, the B
# pairs discovery skips, and the split: fit on the first 24 of the 28 W
# pairs in discovery's order with 3 augmentations per image, validate on
# the last 4, 1 epoch; predict all 28.
DATA_GROUPS = ((20, (1040, 1392)), (8, (768, 1024)))
DATA_B_PAIRS, DATA_TRAIN, DATA_AUGMENTATIONS = 4, 24, 3
DATA_CONFIG = dict(TRAIN_CONFIG, num_epochs=1)
# (g): canonical images from the card's resize and the CPU's within one
# level at no more than this share of pixels (float32 sums in another
# order; a sum an ulp either side of a half rounds either way); masks
# exact. (h): a transform's apply on the card against the CPU's within
# one level on the images, masks equal at all but this share of pixels.
TOL_CANON_SHARE = 1e-3

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
    with torch.inference_mode():
        return _profile_calls(lambda: model(x), forwards)


def _profile_calls(fn, calls: int) -> dict:
    """``_device_profile``'s numbers for ``calls`` calls of ``fn``, after
    one unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
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
                profile_busy_ms=busy / calls,
                profile_port_kernels_ms=port / calls,
                profile_port_kernels_share=port / max(busy, 1e-9),
                profile_top=[[n[:80], t / calls] for n, t in top])


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


def _blob_images(n, size, rng):
    """n canonical uint8 images (blobs on a noisy background) and their
    binary masks."""
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        for _ in range(rng.integers(3, 9)):
            cy, cx = rng.integers(0, size, 2)
            r = rng.uniform(size / 40, size / 10)
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    imgs = rng.normal(60, 15, (n, size, size)) + 90.0 * masks
    return imgs.clip(0, 255).astype(np.uint8), masks


def _step_check(device, size=64) -> dict:
    """Check (a): one train step of resnet_tiny on ``device`` in f32 and
    in float64 against the same step on the CPU in float64, same weights
    and batch."""
    from segtpu_torch.train.engine import TrainState, get_engine
    cfg = {"backbone": "resnet_tiny", "use_attention": True,
           "loss_fn": "combo"}
    ref_eng, eng = get_engine(cfg, device="cpu"), get_engine(cfg,
                                                             device=device)
    ref = ref_eng.init_state(torch.Generator().manual_seed(SEED), 1e-3, 1e-5)
    init = ref.model.state_dict()
    x = np.random.default_rng(SEED + 2).uniform(0, 1, (2, 1, size, size))
    x = torch.from_numpy(x.astype(np.float32)).double().contiguous(
        memory_format=torch.channels_last)            # f32 values
    y = (x > 0.6).double()
    ref.model.double()
    ref.optimizer = ref_eng.make_optimizer(ref.model, 1e-3, 1e-5)
    _, m_ref = ref_eng.train_step(ref, x, y)
    want = {k: p.grad for k, p in ref.model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in want.values())
    sd_ref = ref.model.state_dict()
    res = {}
    for dtype, tol in ((torch.float32, TOL_STEP_F32),
                       (torch.float64, TOL_STEP_F64)):
        model = eng.build_model()
        model.load_state_dict(init)
        model.to(dtype)
        st = TrainState(model, eng.make_optimizer(model, 1e-3, 1e-5))
        _, m = eng.train_step(st, x.to(device, dtype), y.to(device, dtype))
        loss = abs(float(m["loss"]) - float(m_ref["loss"])) / abs(
            float(m_ref["loss"]))
        grad, worst = max(
            (float((p.grad.double().cpu() - want[k]).abs().max())
             / max(float(want[k].abs().max()), 1e-2 * gmax), k)
            for k, p in model.named_parameters())
        sd = model.state_dict()
        var = max(float(((sd[k].double().cpu() - v).abs() / v).max())
                  for k, v in sd_ref.items() if k.endswith("running_var"))
        dt = str(dtype).removeprefix("torch.")
        for name, err in (("loss", loss), ("running_var", var),
                          ("grad", grad)):
            check(err <= tol[name], f"train (a): {dt} step on {device} vs "
                  f"the CPU's float64 step: {name} err {err:.3g} (tol "
                  f"{tol[name]}" + (f"; worst {worst})" if name == "grad"
                                    else ")"))
        res.update({f"step_{dt}_loss_rel_err": loss,
                    f"step_{dt}_grad_err": grad,
                    f"step_{dt}_grad_worst": worst,
                    f"step_{dt}_running_var_rel_err": var})
    return res


def _timed_epochs(seg) -> list:
    """Wrap the engine's epochs in the host clock; returns the epoch
    seconds, filled as it runs."""
    eng, epochs = seg.engine, []
    epoch = eng.run_train_and_eval_epoch

    def timed_epoch(*a, **kw):
        t0 = time.perf_counter()
        out = epoch(*a, **kw)            # ends in a host fetch
        epochs.append(time.perf_counter() - t0)
        return out

    eng.run_train_and_eval_epoch = timed_epoch
    return epochs


def _step_ms(engine, state, x, y, steps: int) -> list:
    """CUDA-event ms of each of ``steps`` train steps on one resident
    batch, enqueued back to back with no host sync between them, after
    one untimed step: each span is the step's wall time as the device
    sees it, host gaps included."""
    engine.train_step(state, x, y)
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in spans:
        start.record()
        engine.train_step(state, x, y)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in spans]


def _kernel_vs_plain(seg, images, masks, use_kernel, kernel, label) -> dict:
    """Checks (d), (e) and (i): ``seg``'s trained model with its kernel
    (``use_kernel(model, True)``) and without, on the same images:
    ``predict_proba`` (all images in one forward) within §2's 0.05 bar,
    the IoU (``evaluate``) within TOL_TRAIN_IOU; the kernel must have
    launched in the kernel's turn."""
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    model = seg.state.model
    use_kernel(model, True)
    reset_launch_counts()
    p_on = seg.predict_proba(images)
    iou_on = seg.evaluate(images, masks)["iou"]
    launched = launch_counts()[kernel]
    use_kernel(model, False)
    p_off = seg.predict_proba(images)
    iou_off = seg.evaluate(images, masks)["iou"]
    use_kernel(model, True)
    perr = float(np.abs(p_on - p_off).max())
    check(launched > 0 and perr <= TOL_PROBS
          and abs(iou_on - iou_off) <= TOL_TRAIN_IOU,
          f"{label}: {kernel} ({launched} launches) vs the unfused "
          f"model: probs max_abs_err {perr:.3g} (tol {TOL_PROBS}), IoU "
          f"{iou_on:.4f} vs {iou_off:.4f} (tol {TOL_TRAIN_IOU})")
    return dict(launches=launched, probs_err=perr, iou=[iou_on, iou_off])


def _gate_on(model, on):
    model.fuse_gate = on


def _gate_at_path_inputs(seg, images) -> dict:
    """Check (i): every gate call of one ``predict_proba`` forward of
    ``images`` (all of them in one forward, so the gate runs at B = their
    count on four levels): the kernel's output there against the plain
    version on the same inputs, within TOL_BF16 of the output's scale."""
    import segtpu_torch.models.attention as attention
    from segtpu_torch.kernels.attention_gate import attention_gate_plain
    kernel, calls = attention.attention_gate, []

    def record(*args):
        out = kernel(*args)
        calls.append(([a.clone() for a in args], out.clone()))
        return out

    attention.attention_gate = record
    try:
        seg.predict_proba(images)
    finally:
        attention.attention_gate = kernel
    torch.cuda.synchronize()
    shapes, errs, shares, ok = [], [], [], len(calls) == 4
    for args, out in calls:
        ref = attention_gate_plain(*[a.float() for a in args])
        err = (out.float() - ref).abs().max().item()
        tol = TOL_BF16 * max(1.0, ref.abs().max().item())
        ok = ok and err <= tol and out.shape[0] == len(images)
        shapes.append([*out.shape[:3], args[0].shape[-1], out.shape[-1],
                       args[2].shape[-1]])
        errs.append(err)
        shares.append(err / tol)
    check(ok, f"data (i): attention_gate at the predict forward's inputs, "
          f"{len(calls)} calls (want 4), (B, H, W, Cg, Cx, F) {shapes}: "
          f"max_abs_err {errs}, {shares} of the tolerance ({TOL_BF16:.3g} "
          f"of each output's scale)")
    return dict(gate_path_shapes=shapes, gate_path_max_abs_err=errs,
                gate_path_tol_share=shares)


def _optimizer_step_refolds(seg, device) -> dict:
    """Check (d): the optimizer alone, with no forward, bumps the version
    counter of every gate parameter (and no BatchNorm statistic), so the
    next no-grad fold is new and equals a fresh fold."""
    model, opt = seg.state.model, seg.state.optimizer
    gates = [getattr(model, f"attention{lvl}") for lvl in (4, 3, 2, 1)]
    dt = seg.engine.compute_dtype              # the validation pass's
    with torch.inference_mode():                     # cache the folds
        cached = [g.folded(dt) for g in gates]
    params = [p for g in gates for p in g.parameters()]
    stats = [b for g in gates for b in g.buffers()]
    p_ver = [p._version for p in params]
    s_ver = [b._version for b in stats]
    gen = torch.Generator(device=device).manual_seed(SEED)
    for p in model.parameters():
        p.grad = 1e-3 * torch.randn(p.shape, generator=gen, device=device)
    opt.step()
    opt.zero_grad(set_to_none=True)
    bumped = all(p._version > v for p, v in zip(params, p_ver))
    still = [b._version for b in stats] == s_ver
    with torch.inference_mode():
        new = [g.folded(dt) for g in gates]
        fresh = [g.fold(dt) for g in gates]
    refolded = all(n is not c for n, c in zip(new, cached))
    equal = all(torch.equal(a, b) for n, f in zip(new, fresh)
                for a, b in zip(n, f))
    check(bumped and still and refolded and equal,
          f"train (d): {type(opt).__name__}.step() alone (defaults "
          f"{ {k: opt.defaults.get(k) for k in ('foreach', 'fused')} }): "
          f"every gate parameter's version rose {bumped}, no gate "
          f"BatchNorm statistic changed {still}, every gate refolded "
          f"{refolded}, the new folds equal fresh ones {equal}")
    return dict(opt_step_bumped_versions=bumped, opt_step_refolded=refolded)


def phase_training(device="cuda", backbone="resnet34", size=SIZE) -> dict:
    """The training path through ``segtpu_torch.api.Segmenter``: checks
    (a)-(e) of the module docstring and the ``train`` line. Returns it."""
    from segtpu_torch.api import Segmenter
    from segtpu_torch.data.preprocess import normalize_canonical
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    res = _step_check(device)
    rng = np.random.default_rng(SEED)
    n = TRAIN_IMAGES + VAL_IMAGES
    imgs, masks = _blob_images(n, size, rng)
    tr, va = slice(0, TRAIN_IMAGES), slice(TRAIN_IMAGES, n)
    test_imgs, _ = _blob_images(PREDICT_IMAGES, size, rng)
    config = dict(TRAIN_CONFIG, img_size=(size, size))

    seg = Segmenter(backbone=backbone, use_attention=True, config=config,
                    device=device)
    epochs = _timed_epochs(seg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    seg.fit(imgs[tr], masks[tr], imgs[va], masks[va])
    fit_counts = launch_counts()
    seg.predict_proba(test_imgs)
    counts = launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in seg.history["train_metrics"]
              + seg.history["val_metrics"]]
    check(all(np.isfinite(losses)), f"train (b): bf16 losses finite "
          f"({losses})")
    val_forwards = config["num_epochs"] * -(-VAL_IMAGES
                                            // config["batch_size"])
    gate = counts["attention_gate"]
    check(fit_counts["attention_gate"] == 4 * val_forwards
          and gate == 4 * (val_forwards + 1),
          f"train (c): attention_gate launched {fit_counts['attention_gate']}"
          f" times in fit's {val_forwards} validation forwards, {gate} with "
          "the predict forward (want 4 per forward)")
    check(all(v == 0 for k, v in counts.items() if k != "attention_gate"),
          f"train (c): no other kernel launched ({counts})")

    # (d): the trained model with the gate kernel and without it, after
    # fit and after an optimizer step alone, which must refold the gates
    after_fit = _kernel_vs_plain(seg, imgs[va], masks[va], _gate_on,
                                 "attention_gate", "train (d) after fit")
    res.update(_optimizer_step_refolds(seg, device))
    after_step = _kernel_vs_plain(seg, imgs[va], masks[va], _gate_on,
                                  "attention_gate",
                                  "train (d) after an optimizer step alone")

    # the step time: TIMED_STEPS steps on one resident batch; the device's
    # busy share is the profiled device time per step over that time
    x = torch.from_numpy(imgs[tr][:config["batch_size"]]).to(device)
    xs = normalize_canonical(x).contiguous(memory_format=torch.channels_last)
    ys = torch.from_numpy(masks[tr][:config["batch_size"]]).to(device)
    ys = ys[:, None].float()
    step_ms = _step_ms(seg.engine, seg.state, xs, ys, TIMED_STEPS)
    step_med = statistics.median(step_ms)
    try:
        profiled = _profile_calls(
            lambda: seg.engine.train_step(seg.state, xs, ys), 3)
    except Exception as exc:
        profiled = {"profile_error": repr(exc)}
    check("profile_busy_share" in profiled, f"train: profiled train step "
          f"({profiled.get('profile_error', 'ok')})")

    # (e): no-attention, 1 epoch: the validation pass runs the upsample,
    # and the trained model agrees with itself run without it
    plain_seg = Segmenter(backbone=backbone, use_attention=False,
                          config=dict(config, num_epochs=1), device=device)
    reset_launch_counts()
    plain_seg.fit(imgs[tr], masks[tr], imgs[va], masks[va])
    ups = launch_counts()["upsample2x_concat"]
    check(ups > 0, f"train (e): no-attention validation launched "
          f"upsample2x_concat {ups} times")

    def fuse_on(model, on):
        model.fuse = "kernel" if on else "none"

    upsample = _kernel_vs_plain(plain_seg, imgs[va], masks[va], fuse_on,
                                "upsample2x_concat", "train (e) after fit")

    quart = statistics.quantiles(step_ms, n=10)
    res.update(
        model="attention", backbone=backbone, size=size,
        batch=config["batch_size"], epochs=config["num_epochs"],
        train_images=TRAIN_IMAGES, val_images=VAL_IMAGES,
        step_ms=step_med, step_ms_p10=quart[0], step_ms_p90=quart[-1],
        step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        timed_steps=len(step_ms),
        img_per_s=config["batch_size"] / step_med * 1e3,
        max_memory_gib=peak, host_s_per_epoch=epochs,
        launches=counts, upsample_launches_no_attention=ups,
        losses=losses, val_iou=seg.history["val_metrics"][-1]["iou"],
        gate_after_fit=after_fit, gate_after_opt_step=after_step,
        upsample_after_fit=upsample, **profiled)
    if "profile_busy_ms" in profiled:
        res["busy_share_unprofiled"] = profiled["profile_busy_ms"] / step_med
    print("train " + json.dumps(res), flush=True)
    return res


def _write_w_group(root, n, raw, rng):
    """n W pairs of blobs at ``raw`` under names of their own (discovery
    sorts them after ``make_synthetic_dataset``'s); returns the arrays
    written, by path."""
    import os
    from segtpu_torch.data.io import write_tiff
    written = {}
    yy, xx = np.mgrid[:raw[0], :raw[1]]
    for i in range(n):
        mask = np.zeros(raw, np.uint8)
        for _ in range(rng.integers(3, 7)):
            cy, cx = rng.integers(0, raw[0]), rng.integers(0, raw[1])
            r = rng.uniform(raw[0] / 40, raw[0] / 12)
            mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 255
        img = (rng.normal(60, 15, raw) + 0.35 * mask).clip(0, 255).astype(
            np.uint8)
        stem = f"Img_C_D_2W_{i:03d}"
        for sub, name, arr in (("Labelled_images", f"{stem}.tif", img),
                               ("GT_masks", f"{stem}_GT.tif", mask)):
            path = os.path.join(root, sub, name)
            write_tiff(path, arr)
            written[path] = arr
    return written


def _file_pixels(path, shape):
    """The pixels of a TIFF that ``write_tiff`` wrote: its last H·W bytes
    (one uncompressed strip at the end), read without any decoder."""
    with open(path, "rb") as f:
        data = f.read()
    return np.frombuffer(data[-shape[0] * shape[1]:], np.uint8).reshape(
        shape)


def _augment_checks(canon_i, canon_m, device) -> dict:
    """Check (h): ``CellAugmenter`` on the card and the production
    transforms' apply on the card against the CPU. Returns its numbers."""
    from segtpu_torch.data import augment
    n = canon_i.shape[0]
    aug = augment.CellAugmenter(DATA_AUGMENTATIONS, seed=SEED, device=device)
    ai, am = aug.augment_training_data(canon_i, canon_m)
    torch.cuda.synchronize()
    first = (torch.equal(ai[:n].cpu(), torch.from_numpy(canon_i))
             and torch.equal(am[:n].cpu(), torch.from_numpy(canon_m)))
    binary = set(am.unique().tolist()) <= {0, 1}
    check(first and binary and ai.shape[0] == n * (DATA_AUGMENTATIONS + 1),
          f"data (h): CellAugmenter on {device}: {ai.shape[0]} frames (want "
          f"{n * (DATA_AUGMENTATIONS + 1)}), the first {n} the originals bit "
          f"for bit {first}, masks binary {binary}")
    per_image_ms = host_ms(lambda: aug.augment_training_data(
        canon_i, canon_m), iters=3) / (n * DATA_AUGMENTATIONS)
    # each production transform: the same draws (made on the CPU) applied
    # on the card and on the CPU, to 4 canonical frames
    img = torch.from_numpy(canon_i[:4]).float()
    mask = torch.from_numpy(canon_m[:4]).float() * 255
    worst = {}
    for t, _, _ in augment._production_pipeline().steps:
        name = type(t).__name__
        params = t.draw(torch.Generator().manual_seed(SEED), 4,
                        img.shape[-1])
        on_card = {k: v.to(device) for k, v in params.items()}
        wi, wm = t.apply(img, mask, params)
        gi, gm = (x.cpu() for x in t.apply(img.to(device), mask.to(device),
                                           on_card))
        levels = float((torch.floor(gi + 0.5)
                        - torch.floor(wi + 0.5)).abs().max())
        mask_share = float((gm != wm).float().mean())
        moved = True           # an image that is its mask stays its mask
        if name in ("RandomRotate90", "VerticalFlip"):
            a, b = t.apply(mask.to(device), mask.to(device), on_card)
            moved = torch.equal(a, b)
        check(levels <= 1 and mask_share <= TOL_CANON_SHARE and moved,
              f"data (h): {name} apply on {device} vs the CPU, same draws: "
              f"{levels:g} levels (tol 1), masks differ at {mask_share:.3g} "
              f"(tol {TOL_CANON_SHARE}), mask moved as the image {moved}")
        worst[name] = [levels, mask_share]
    return dict(augment_ms_per_image=per_image_ms, augment_frames=int(
        ai.shape[0]), augment_vs_cpu=worst)


def phase_data(device="cuda", backbone="resnet34", size=SIZE) -> dict:
    """The flagship fitted from a directory of TIFFs with the production
    augmentation: checks (f)-(i) of the module docstring and the ``data``
    line. Returns it."""
    import os
    import tempfile
    from segtpu_torch.api import Segmenter
    from segtpu_torch.data import io
    from segtpu_torch.data.discovery import load_original_data
    from segtpu_torch.data.native import build, native_decode_batch
    from segtpu_torch.data.preprocess import (load_canonical,
                                              load_canonical_images,
                                              normalize_canonical)
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(SEED)
    res = {}
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-data-") as root:
        (n_a, raw_a), (n_b, raw_b) = DATA_GROUPS
        t0 = time.perf_counter()
        io.make_synthetic_dataset(root, n_images=n_a, image_type="W",
                                  raw_size=raw_a, seed=SEED)
        io.make_synthetic_dataset(root, n_images=DATA_B_PAIRS,
                                  image_type="B", raw_size=(256, 256),
                                  seed=SEED + 1)
        written = _write_w_group(root, n_b, raw_b, rng)
        res["write_s"] = time.perf_counter() - t0
        data = load_original_data(root, image_type="W")
        ip, mp = data["image_paths"], data["mask_paths"]
        names = sorted(os.listdir(os.path.join(root, "GT_masks")))
        want = [m for m in names if m.endswith("GT.tif")
                and m.split("_")[3][1] == "W"]
        check(len(ip) == n_a + n_b and [os.path.basename(m) for m in mp]
              == want and all(os.path.basename(i) == os.path.basename(m)[
                  :-7] + ".tif" for i, m in zip(ip, mp)),
              f"data: load_original_data paired {len(ip)} W files (want "
              f"{n_a + n_b}) in the masks' sorted order, no B file")

        seg = Segmenter(backbone=backbone, use_attention=True,
                        config=dict(DATA_CONFIG, img_size=(size, size)),
                        device=device)
        epochs = _timed_epochs(seg)
        tr, va = slice(0, DATA_TRAIN), slice(DATA_TRAIN, len(ip))
        # the TIFF reader's one-time g++ build, outside the fit's window
        t0 = time.perf_counter()
        build()
        res["reader_build_s"] = time.perf_counter() - t0
        io.clear_decode_cache()
        io.reset_decode_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        seg.fit(ip[tr], mp[tr], ip[va], mp[va],
                augmentations_per_image=DATA_AUGMENTATIONS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts = launch_counts()
        pred = seg.predict(ip)
        counts = launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        decoded = io.decode_counts()

        # (f): every W file decoded once, natively, to the pixels written
        exact = all(np.array_equal(
            io.decode_gray(p), written[p] if p in written
            else _file_pixels(p, io.decode_gray(p).shape)) for p in ip + mp)
        check(decoded == {"native": 2 * len(ip), "pil": 0} and exact,
              f"data (f): decodes {decoded} (want native {2 * len(ip)}, "
              f"pil 0); every file's pixels as written {exact}")

        # (i): the gate kernel in every validation and predict forward
        val_forwards = -(-len(ip[va]) // DATA_CONFIG["batch_size"])
        gate = counts["attention_gate"]
        losses = [m["loss"] for m in seg.history["train_metrics"]
                  + seg.history["val_metrics"]]
        check(fit_counts["attention_gate"] == 4 * val_forwards
              and gate == 4 * (val_forwards + 1)
              and all(v == 0 for k, v in counts.items()
                      if k != "attention_gate"),
              f"data (i): attention_gate launched {fit_counts['attention_gate']}"
              f" times in fit's {val_forwards} validation forwards, {gate} "
              f"with the predict forward (want 4 per forward); {counts}")
        check(bool(np.isfinite(losses).all()), f"data (i): losses finite "
              f"({losses})")
        canon_i = load_canonical_images(ip, (size, size), device=device)
        same = np.array_equal(seg.predict(canon_i), pred)
        check(same and pred.shape == (len(ip), size, size, 1),
              f"data (i): predict(paths) {pred.shape} equals predict of "
              f"their canonical frames: {same}")

        # timings, then (g): the card's canonical frames against the CPU's
        io.clear_decode_cache()
        t0 = time.perf_counter()
        native_decode_batch(ip + mp)
        res["native_decode_ms_per_file"] = (
            (time.perf_counter() - t0) * 1e3 / len(ip + mp))
        io.clear_decode_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ci, cm = load_canonical(ip, mp, (size, size), device=device)
        torch.cuda.synchronize()
        res["load_canonical_ms"] = (time.perf_counter() - t0) * 1e3
        res["load_canonical_ms_cached"] = host_ms(
            lambda: load_canonical(ip, mp, (size, size), device=device),
            iters=3)
        wi, wm = load_canonical(ip, mp, (size, size), device="cpu")
        diff = np.abs(ci.astype(np.int16) - wi)
        levels, share = int(diff.max()), float((diff > 0).mean())
        check(np.array_equal(cm, wm) and levels <= 1
              and share <= TOL_CANON_SHARE,
              f"data (g): load_canonical on {device} vs the CPU: masks equal "
              f"{np.array_equal(cm, wm)}, images {levels} levels apart at "
              f"{share:.3g} of pixels (tol 1 at {TOL_CANON_SHARE})")
        # (i) at the predict forward's batch of 28: the model with the
        # gate kernel against the unfused gate, and the kernel against its
        # plain version on the inputs that forward gives it
        res["gate_vs_unfused"] = _kernel_vs_plain(
            seg, ci, cm, _gate_on, "attention_gate",
            f"data (i) after fit, B={len(ip)}")
        res.update(_gate_at_path_inputs(seg, ci))
        x = torch.from_numpy(ci).to(device)
        res["normalize_ms"] = time_ms(lambda: normalize_canonical(x))
        res.update(_augment_checks(ci[tr], cm[tr], device))

    steps = -(-DATA_TRAIN * (DATA_AUGMENTATIONS + 1)
              // DATA_CONFIG["batch_size"])
    res.update(
        backbone=backbone, size=size, pairs=len(ip),
        raw_shapes=[list(raw_a), list(raw_b)],
        train_images=DATA_TRAIN * (DATA_AUGMENTATIONS + 1),
        val_images=len(ip) - DATA_TRAIN, predict_images=len(ip),
        decodes=decoded, fit_host_s=fit_s, steps=steps,
        epoch_host_s=epochs,
        # the epoch's training images over its host seconds (its 12 steps,
        # the validation forward and the metrics' fetch)
        epoch_img_per_s=DATA_TRAIN * (DATA_AUGMENTATIONS + 1) / epochs[0],
        max_memory_gib=peak, launches=counts,
        canonical_vs_cpu=[levels, share], losses=losses,
        allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32],
        clock="host s (write, reader build, fit, epoch, decode, "
              "load_canonical, augment); "
              "CUDA events (normalize)")
    print("data " + json.dumps(res), flush=True)
    return res


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
    trained = phase_training()
    loaded = phase_data()
    # each kernel's launches on its own main paths: the serving model and
    # the training runs that run it, or the bench entry points for the
    # conv and the pair
    launches = {"attention_gate": served["attention_gate"]["launches"]
                + trained["launches"]["attention_gate"]
                + loaded["launches"]["attention_gate"],
                "upsample2x_concat": served["upsample2x_concat"]["launches"]
                + trained["upsample_launches_no_attention"],
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
