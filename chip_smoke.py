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
9. encoders and grid: (j) resnet50 and densenet121, each with and
   without attention, at full width and depth (random weights, BatchNorm
   statistics from one random batch), answer one ``predict_proba``
   request of 16 images of 512² in bf16 through their kernels (4 gate
   launches per attention forward; an upsample launch per level
   ``_fused_level`` fuses without attention, 3 at B=16), held against
   the same weights in f32 without kernels (§ serving's bars); the
   forward with and without kernels (median of 3 alternated turns of 5),
   peak memory; every gate and upsample call of those forwards against
   its plain version in f32 and bf16, summed apart from the flagship's;
   an ``encoders {...}`` line. (k) a torchvision-format resnet50 and
   densenet121 checkpoint (random weights, torchvision's key names)
   through ``Segmenter(config={"encoder_checkpoint": {backbone:
   path}})``: before any step every encoder tensor on the card equals the
   file's bit for bit (the stem its RGB sum), the rest the seed's fresh
   init; then ``load_pretrained_encoder``. (l) the model-configuration
   grid (resnet34/resnet50 × attention on/off, batch 4) through
   ``ModelConfigurationExperiment`` and the K-fold harness on the data
   phase's TIFFs, the experiment's base config (128², test_size 0.3,
   random_state 41, BCE) cut to 2 folds, 2 epochs and 1 augmentation per
   image: finite IoUs, identical folds across configurations, the JSON
   artefacts read back, every model on the card, 4 gate launches per
   validation forward of the attention configurations; a ``grid {...}``
   line with the seconds per configuration and per fold;
10. fold-parallel training and forward selection on the data phase's
   TIFFs: (m1) ``CrossValidator`` with the grid's resnet34 attention
   configuration (128², B=4, BCE, random_state 41, 2 folds, 2 epochs, 1
   augmentation per image), sequential, then ``fold_parallel=True`` with
   the ``stream`` and the ``vmap`` strategy, cuDNN deterministic in all
   three: each fold's final IoU and loss within 1e-2 of the sequential
   run's; ``vmap``'s per-epoch losses within 1e-2 of ``stream``'s (its
   thresholded metrics reported: in float32 the two strategies round
   differently and a 2-epoch model's IoU swings with that), and the two
   strategies equal in float64 on the card (weights within 1e-9 of their
   scale, without the gate kernel); one device→host fetch per ``stream``
   window (per epoch under ``vmap``), exactly 4 gate launches per
   validation forward, every fold's model on the card, one fold's epoch
   profiled (the device's busy share); (m3) the sequential run's
   first fold with ``metrics_log`` and ``tensorboard_dir``, read back
   (one record and one event per epoch, the epoch's metrics), and
   ``core.profiling.trace`` around a validation forward, whose trace must
   name the gate kernel; a ``folds {...}`` line with seconds per CV, per
   fold and per epoch and the peak memory of each mode. (m2) the
   forward-selection driver's base config (resnet34, no attention, 128²,
   B=2, focal, seed 42) cut to ``horizontal_flip`` and ``random_crop``,
   one round, 3 grouped folds, 2 epochs, sequential and fold-parallel:
   no base name on both sides of a fold, ``results.json`` read back,
   scores finite in [0, 1], 3 sets × 3 folds trainings per mode, every
   model on the card, the upsample launches ``_fused_level`` predicts
   (0); a ``selection {...}`` line;
11. inference and deployment (n), on the serving phase's random
   flagship weights in a bf16 ``Segmenter`` (f32 parameters): (n1) four
   synthetic 2048² slides through ``make_tiled_predictor_many`` in halo
   mode at overlap 32 (16 tiles of 544² per slide) and blend mode at tile
   512, overlap 64 (25 tiles per slide): 4 gate launches per forward,
   the probabilities and logits against the same tiler over the f32
   model without kernels (§ serving's bars or, where bf16 alone misses
   them, 1.25× bf16's own error), MPix/s (host clock, synchronised) and
   peak memory; ``Segmenter.predict_tiled`` in halo mode, each output
   tile against the model's direct bf16 forward of its padded window, and
   each gate call of that forward against the plain version; (n2)
   ``predict_proba(tta=True)`` on 16 images of 512² (8 forwards, 32 gate
   launches) against the f32 TTA without kernels, img/s; (n3)
   ``Segmenter.export`` with a symbolic batch, the same weights exported
   on the CPU, and the no-attention flagship's artifact, each loaded by
   ``ServingModel(path, device="cuda")`` in a fresh process where
   ``segtpu_torch.models`` cannot be imported: batches 1, 5 and 16
   against the live bf16 ``predict_proba`` within TOL_ARTIFACT (which the
   f32 model must miss), 4 gate launches per forward from both attention
   artifacts, one upsample launch per frozen fused level without
   attention, and ``make_server(tiled=True)`` answering a 512² batch and
   a 2048² slide with the ``ServingModel``'s own arrays; ``tiled``,
   ``tta`` and ``serving_tiled`` lines;
12. the fused training run (o), cuDNN deterministic: (o1) the flagship
   (resnet34, attention, 512², bf16, B=8; 20 training images, two full
   batches and a remainder of 4, and 4 validation images) through
   ``train_model`` with ``fused_run`` and stepwise, the plateau
   scheduler cutting unless the IoU grows elevenfold, early stopping
   after epoch 2 of 3: epochs run, LR history and best epoch equal,
   per-epoch losses within 1e-4 of themselves, the two models'
   probabilities within 0.05, 4 gate launches per replayed validation
   forward and warm-up call, a second run of equal shapes replaying
   without a new capture, the host syncs per epoch (the runner's count
   and ``set_sync_debug_mode``'s), a profiled replayed epoch naming
   ``gate_bf16_kernel`` once per gate call, replayed and stepwise steps
   on one resident batch (CUDA events, profiled busy share); (o2) the
   no-attention flagship, whose replayed validation forwards launch the
   upsample as often as ``_fused_level`` predicts; (o3) adam, adamw, sgd
   and lamb under capture at 64² in f32 against stepwise, 3 epochs with
   LR cuts; (o4) the models handed back by a fused run (one of them with
   folds cached before it) against themselves refolded; (o5) a 2-fold
   CV of (m1)'s configuration with ``fused_run``: one capture for both
   folds, each fold within 1e-2 of the stepwise CV; a ``fused {...}``
   line;
13. multi-device (p), cuDNN deterministic; one card, so no scaling is
   measured: (p1) NCCL with one rank in this process (a ``file://``
   rendezvous): ``DataParallel`` over the card, one DP step of the bf16
   flagship (512², B=8) equal to the plain engine's step bit for bit
   (loss, metrics, parameters, BatchNorm statistics); two epochs of
   ``run_train_and_eval_epoch_async`` over ``shard_loader`` loaders (16 +
   4 images) enqueued before one fetch, with the plateau LR and early
   stopping, 4 gate launches per validation forward; the DP and the plain
   step alternated, 30 CUDA-event spans each (the wrapper's own cost); the
   no-attention flagship's DP validation forward launching the upsample
   as ``_fused_level`` predicts. (p2) two ranks of this script
   (``--md-rank``) on the card over gloo (NCCL refuses two ranks on one
   device), each of which must exit 0 with its tensors on ``cuda``: the
   f32 flagship's DP step at global B=8 and an A=2 accumulated step
   against the same steps in one process (loss within 1e-4 of itself,
   running statistics within 1e-3 of their scale, the summed gradients
   within 1e-3 of the largest; rank-local statistics and gradients, and
   a mean in place of the gradients' sum, shown to miss that), the bf16 DP step's time, ``spatial_predict`` of a
   2048² slide over 2 bands (halo 32, 1088×2048 band forwards) against
   the two haloed bands forwarded in one process, and the halo and blend
   tilers with ``shard_tiles_axis="data"`` against the unsharded tiler
   (probabilities within 2^-8), 4 gate launches per band and tile-batch
   forward on each rank; (p4) one profiled world-2 step read by
   ``segtpu_torch.core.hlo_profile``: the gradient all-reduce carries the
   parameters' bytes, and the BatchNorm syncs are 2 per BatchNorm. (p3)
   2 folds through ``train_folds_parallel(devices=["cuda:0", "cuda:0"])``
   equal to the default placement. A ``multidevice {...}`` line.
   (q2), on the same two ranks after (p2): the flagship (resnet34,
   attention) on a (data 1 × spatial 2) mesh, B=8 512² placed
   ``[Shard(0), Shard(2)]``, so each rank holds a band of 256×512: the
   f32 SGD step against the one-process step (loss, running statistics,
   the update within 1e-3 of the largest), a control whose bands are
   zero-padded in place of the exchanged halo rows missing that bar, the
   bf16 step's time (median of 10), one profiled step's collectives (the
   halo rows by point-to-point sends and receives, 2 all-gathers, the
   gradient all-reduce), the engine's bf16 eval step and validation
   forwards on the bands in f32 (against one process within 1e-5, and
   the zero-padded control's f32 forward missing that bar) and bf16 (its
   error reported), 4 gate launches each per rank; a
   ``spatial_train {...}`` line;
14. the reparameterisations (q1): the flagship's stem alone at B=16 512²
   bf16, plain 7×7/s2, s2d (the default) and s2d padded to 8 phase
   channels, alternated call by call over 20 turns (CUDA events after an
   L2 flush, medians); the serving forward with the s2d stem and the
   plain one, alternated (the default, ``stem_s2d=True``, must be the
   form that is faster alone); the s2d forward with the gate kernel
   against the f32 model without kernels and with the plain stem (§
   serving's bars, or 1.25× the bf16 model's own error with the plain
   stem where that misses them; 4 gate launches); one
   ``reparam_in_train`` train step of
   resnet_tiny in f32 and float64 on the card against the CPU's float64
   step (check (a)'s bars); a ``reparam {...}`` line;
15. the data-parallel fused run (r), cuDNN deterministic, on (p)'s
   groups (no new process): (r1) on (p1)'s NCCL mesh of one rank,
   ``run_training_fused`` with (o1)'s flagship configuration (resnet34,
   attention, 512², bf16, B=8, 20 training and 4 validation images, 3
   epochs, the plateau scheduler and early stopping) against the same run
   in one process: histories, decisions and the final and returned
   weights equal bit for bit, a runner and graphs of its own, 4 gate
   launches per replayed validation forward and warm-up call, a second
   run of equal shapes replaying without a new capture; both runners'
   replayed steps and the stepwise DP step alternated (CUDA events,
   medians of 30); the no-attention flagship's DP run launching the
   upsample from its replays as ``_fused_level`` predicts; (r1k) the
   same DP run with its one-rank group kept in every step
   (``one_rank_sync``), so that the graphs capture the BatchNorms'
   all-reduces, the gathers and the gradients' all-reduce: equal to the
   same steps called eagerly bit for bit, a second run calling no
   collective from Python, its first run's peak memory, its replayed step
   timed with the others and profiled beside the plain DP replay (the
   five costliest kernels of each); (r1c) the collective helpers (``all_reduce_`` on the gradients' 97,764,916
   bytes, ``all_reduce_sum`` on the BatchNorms' sums, ``broadcast_``,
   ``all_gather_rows`` of a logits batch) captured in one CUDA graph and
   replayed twice on new inputs, equal to the eager calls bit for bit
   (at world 1 the in-place reductions cannot be told apart from the
   identity; the gather's output can). (r2) on (p2)'s two gloo ranks: ``run_training_fused`` on the gloo mesh
   with CUDA tensors must refuse to capture; the eager DP runner
   (``graphs=False``, f32, 12 training and 4 validation images, 2
   epochs) against the stepwise DP epochs by (p2)'s bars (decisions
   equal, losses within 1e-4 of themselves, parameters within 1e-3 of the
   largest), 4 gate launches per validation forward on each rank, both
   ranks' histories and weights equal bit for bit. A ``fused_dp {...}``
   line;
16. one JSON line ``{"kernels": [...]}`` (gate and upsample launches
   count every path above, the replays of the fused runs' graphs and both
   world-2 ranks included; their sums over the other encoders' shapes
   under ``encoders``), then the card line, then the result line
   ``{"ok": true, "device": {...}}``.

The weights are random, made from a fixed seed; the BatchNorm running
statistics come from one batch of random images, then jittered.
"""

from __future__ import annotations

import contextlib
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
# The deeper models of the encoders phase: the bf16 model without any
# kernel already misses those bars against the f32 model (resnet50
# attention: probabilities 0.0578, logits 23.2% of max|logit|;
# densenet121 attention: logits 18.1%; NVIDIA H100 80GB HBM3, 700 W),
# so there each is held to §2's bar or, where bf16 alone misses it, to
# 1.25 times the bf16 model's own error without its kernel: the kernels
# may add at most a quarter to bf16's error (they added 0.0%-2.5%: the
# gate keeps its hidden map in f32 and rounds once).
TOL_KERNEL_OVER_BF16 = 1.25
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


def _kernel_records(name, kernel, plain, case, shapes, gen, flush,
                    device, on_path=lambda shape: True) -> list:
    """Each shape's case against its plain version in f32 and bf16, with
    kernel, plain and library times and the bound; prints a line per case
    and returns the bf16 records. ``on_path(shape)``: whether the serving
    forward runs that shape (the record's ``serving``)."""
    records = []
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
                       plain_ms=time_ms(lambda: plain(*args), flush=flush),
                       library_ms=(time_ms(library, flush=flush)
                                   if library else None),
                       serving=on_path(shape),
                       **{k: time_ms(fn, flush=flush)
                          for k, fn in extra.items()})
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
            # achieved rate of the function's own operations, and the
            # share of the least time the kernel reaches
            rec["tflops"] = ops / rec["ms"] * 1e-9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            print("  " + json.dumps(rec), flush=True)
            if dtype == torch.bfloat16:
                records.append(rec)
            del args, ref, library, extra
    return records


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
    return {name: _kernel_records(
        name, kernel, plain, case, shapes, gen, flush, device,
        on_path=lambda shape, name=name: not (
            name == "upsample2x_concat" and shape in UPSAMPLE_OFF_PATH))
        for name, kernel, plain, case, shapes in table}


def _randomized_flagship(use_attention: bool, device="cuda", batch=4,
                         size=SIZE, backbone="resnet34"):
    """The f32 model (the flagship's resnet34 unless told another
    backbone) with weights from the seeded generator and BatchNorm running
    statistics set by one batch of random images (momentum 1), then
    jittered, so the folds see non-trivial values."""
    from segtpu_torch.models.unet import UNetWithBackbone
    torch.manual_seed(SEED)
    model = UNetWithBackbone(backbone=backbone,
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


def _forward_ms(model, x, use_kernels, turns=FORWARD_TURNS) -> tuple:
    """(median ms with kernels, median ms without, both lists) of the
    forward on x, from ``turns`` alternated turns."""
    on, off = [], []
    with torch.inference_mode():
        for _ in range(turns):
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
    from segtpu_torch.core.hlo_profile import PORT_KERNELS
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


def decoder_shapes(model, batch: int, size: int) -> tuple:
    """The kernel calls of ``model``'s eval forward on (batch, 1, size,
    size), from its decoder plan: the gates' (Cg, Cx, F, H=W), levels 4..1
    (with attention), and the upsamples' (Cin, Co, Cs, H=W of x) at the
    levels that ``model._fused_level`` fuses (without attention)."""
    from segtpu_torch.models.backbones import BACKBONE_CHANNELS
    from segtpu_torch.models.unet import _DECODER_PLAN
    plan = _DECODER_PLAN[model.backbone]
    enc = BACKBONE_CHANNELS[model.backbone]
    gates, ups, cin = [], [], enc[4]
    for i, lvl in enumerate((4, 3, 2, 1)):
        hw = size >> (lvl + 1)
        gates.append((plan["up"][i], enc[lvl - 1], plan["att_int"][i],
                      2 * hw))
        if model._fused_level(torch.empty((batch, cin, hw, hw),
                                          device="meta")):
            ups.append((cin, plan["up"][i], enc[lvl - 1], hw))
        cin = plan["dec"][i]
    return (tuple(gates) if model.use_attention else ()), tuple(ups)


def _use_kernels(model, on: bool):
    model.fuse_gate = on
    model.fuse = "kernel" if on else "none"


def phase_serving(use_attention: bool, device="cuda", batch=BATCH,
                  size=SIZE, requests=REQUESTS, backbone="resnet34",
                  turns=FORWARD_TURNS, tag="serving",
                  over_bf16: bool = False) -> dict:
    """``requests`` predict_proba requests through the bf16 model with
    its kernel, the launches they made (4 gates per attention forward;
    an upsample per level ``_fused_level`` fuses without attention), img/s
    with the kernel and without, peak device memory, and the results
    against the f32 model without kernels: within §2's bars
    (TOL_PROBS, TOL_LOGITS_REL), and with ``over_bf16`` within
    TOL_KERNEL_OVER_BF16 of the bf16 model's own error without its kernel
    where that error alone misses them."""
    from segtpu_torch.infer.predict import predict_proba
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    kernel = "attention_gate" if use_attention else "upsample2x_concat"
    label = "attention" if use_attention else "no-attention"
    rng = np.random.default_rng(SEED)
    reqs = [rng.uniform(0, 1, (batch, size, size)).astype(np.float32)
            for _ in range(requests)]

    ref32 = _randomized_flagship(use_attention, device, size=size,
                                 backbone=backbone)
    model = copy.deepcopy(ref32).to(torch.bfloat16)
    gate_shapes, up_shapes = decoder_shapes(model.eval(), batch, size)
    shapes = gate_shapes if use_attention else up_shapes

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

    _use_kernels(model, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs, ips_on, counts = serve(model)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_forward = len(shapes)
    check(counts[kernel] == per_forward * requests,
          f"{label}: {kernel} launched {counts[kernel]} times in "
          f"{requests} requests (want {per_forward} per forward)")
    check(all(n == 0 for k, n in counts.items() if k != kernel),
          f"{label}: no other kernel launched ({counts})")
    _use_kernels(model, False)
    _, ips_off, _ = serve(model)
    x = _device_batch(model, reqs[0], device)
    fwd_on, fwd_off, fwd_on_all, fwd_off_all = _forward_ms(
        model, x, _use_kernels, turns)
    _use_kernels(model, True)
    try:
        profiled = _device_profile(model, x)
    except Exception as exc:
        profiled = {"profile_error": repr(exc)}
    got = profiled.get("profile_port_kernels_ms",
                       profiled.get("profile_error"))
    check(isinstance(got, float) and got > 0,
          f"{label}: the profiled forward shows {kernel}'s device time "
          f"per forward ({got})")

    _use_kernels(ref32, False)
    ok_shape = all(p.shape == (batch, size, size, 1) and np.isfinite(p).all()
                   for p in probs)
    check(ok_shape, f"{label}: {requests} responses of shape "
          f"{(batch, size, size, 1)}, all finite")
    want = [predict_proba(ref32, r, device=device) for r in reqs]
    perr = max(float(np.abs(p - w).max()) for p, w in zip(probs, want))
    _use_kernels(model, True)
    lg_ref = _logits(ref32, reqs[0], device)
    scale = lg_ref.abs().max().item()
    lerr = (_logits(model, reqs[0], device) - lg_ref).abs().max().item()
    # the bf16 model without its kernel against the same reference: the
    # error bf16 arithmetic alone makes
    _use_kernels(model, False)
    lerr_plain = (_logits(model, reqs[0], device) - lg_ref).abs().max().item()
    perr_plain = max(float(np.abs(predict_proba(model, r, device=device)
                                  - w).max()) for r, w in zip(reqs, want))
    _use_kernels(model, True)
    tol_p, tol_l = TOL_PROBS, TOL_LOGITS_REL * scale
    if over_bf16:
        tol_p = max(tol_p, TOL_KERNEL_OVER_BF16 * perr_plain)
        tol_l = max(tol_l, TOL_KERNEL_OVER_BF16 * lerr_plain)
    check(perr <= tol_p, f"{label}: bf16-with-kernel probabilities vs "
          f"f32 plain: max_abs_err {perr:.3g} (tol {tol_p:.3g}; bf16 "
          f"without kernel {perr_plain:.3g})")
    check(lerr <= tol_l,
          f"{label}: bf16-with-kernel logits vs f32 plain: max_abs_err "
          f"{lerr:.3g} (tol {tol_l:.3g}, max|logit| {scale:.3g}; bf16 "
          f"without kernel {lerr_plain:.3g})")
    _use_kernels(ref32, True)
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
    res = dict(model=label, backbone=backbone, requests=requests,
               batch=batch, size=size, launches=counts[kernel],
               launches_per_forward=per_forward,
               kernel_shapes=[list(t) for t in shapes],
               max_memory_gib=peak,
               img_per_s_kernels=ips_on,
               img_per_s_plain=ips_off, forward_ms_kernels=fwd_on,
               forward_ms_plain=fwd_off,
               forward_img_per_s_kernels=batch / fwd_on * 1e3,
               forward_img_per_s_plain=batch / fwd_off * 1e3,
               forward_ms_kernels_turns=fwd_on_all,
               forward_ms_plain_turns=fwd_off_all,
               probs_max_abs_err=perr, logits_max_abs_err=lerr,
               probs_max_abs_err_bf16_plain=perr_plain,
               logits_max_abs_err_bf16_plain=lerr_plain,
               logits_max_abs=scale, **folds, **profiled)
    print(f"{tag} " + json.dumps(res), flush=True)
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


def _step_check(device, size=64, label="train (a)", **extra) -> dict:
    """Check (a): one train step of resnet_tiny on ``device`` in f32 and
    in float64 against the same step on the CPU in float64, same weights
    and batch; ``extra`` config keys for both (``reparam_in_train``,
    (q1))."""
    from segtpu_torch.train.engine import TrainState, get_engine
    cfg = {"backbone": "resnet_tiny", "use_attention": True,
           "loss_fn": "combo", **extra}
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
            check(err <= tol[name], f"{label}: {dt} step on {device} vs "
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


class _GateCalls:
    """Records the inputs and output (copies) of every attention-gate
    kernel call the models make while it is entered."""

    def __enter__(self):
        import segtpu_torch.models.attention as attention
        self.calls, self._kernel = [], attention.attention_gate
        kernel, calls = self._kernel, self.calls

        def record(*args):
            out = kernel(*args)
            calls.append(([a.clone() for a in args], out.clone()))
            return out

        attention.attention_gate = record
        return self

    def __exit__(self, *exc):
        import segtpu_torch.models.attention as attention
        attention.attention_gate = self._kernel

    def against_plain(self, tol: float):
        """Each recorded output against ``attention_gate_plain`` on its
        inputs (in f32): per call its (B, H, W, Cg, Cx, F), max_abs_err and
        the error's share of ``tol`` times the output's scale (floored at
        1)."""
        from segtpu_torch.kernels.attention_gate import attention_gate_plain
        torch.cuda.synchronize()
        shapes, errs, shares = [], [], []
        for args, out in self.calls:
            ref = attention_gate_plain(*[a.float() for a in args])
            err = (out.float() - ref).abs().max().item()
            shapes.append([*out.shape[:3], args[0].shape[-1], out.shape[-1],
                           args[2].shape[-1]])
            errs.append(err)
            shares.append(err / (tol * max(1.0, ref.abs().max().item())))
        return shapes, errs, shares


def _gate_at_path_inputs(seg, images) -> dict:
    """Check (i): every gate call of one ``predict_proba`` forward of
    ``images`` (all of them in one forward, so the gate runs at B = their
    count on four levels): the kernel's output there against the plain
    version on the same inputs, within TOL_BF16 of the output's scale."""
    with _GateCalls() as rec:
        seg.predict_proba(images)
    shapes, errs, shares = rec.against_plain(TOL_BF16)
    ok = len(rec.calls) == 4 and all(s[0] == len(images) for s in shapes) \
        and max(shares) <= 1.0
    check(ok, f"data (i): attention_gate at the predict forward's inputs, "
          f"{len(rec.calls)} calls (want 4), (B, H, W, Cg, Cx, F) {shapes}: "
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


def write_data_dir(root) -> dict:
    """The data phase's directory of TIFFs under ``root``: DATA_GROUPS' W
    pairs (``make_synthetic_dataset``'s, then ``_write_w_group``'s) and
    DATA_B_PAIRS B pairs. Returns the second W group's arrays by path."""
    from segtpu_torch.data import io
    (n_a, raw_a), (n_b, raw_b) = DATA_GROUPS
    io.make_synthetic_dataset(root, n_images=n_a, image_type="W",
                              raw_size=raw_a, seed=SEED)
    io.make_synthetic_dataset(root, n_images=DATA_B_PAIRS, image_type="B",
                              raw_size=(256, 256), seed=SEED + 1)
    return _write_w_group(root, n_b, raw_b, np.random.default_rng(SEED))


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
    res = {}
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-data-") as root:
        (n_a, raw_a), (n_b, raw_b) = DATA_GROUPS
        t0 = time.perf_counter()
        written = write_data_dir(root)
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


# The encoders-and-grid phase: (j) serving through resnet50 and
# densenet121 at full width and depth, with and without attention, B=16,
# 512², bf16, one request each; (k) pretrained encoders; (l) the
# model-configuration grid through the K-fold harness.
ENCODER_MODELS = (("resnet50", True), ("resnet50", False),
                  ("densenet121", True), ("densenet121", False))
ENCODER_REQUESTS, ENCODER_TURNS = 1, 3
# (l): the model-configuration experiment's own base config
# (segtpu_torch/experiments/model_configuration.py::main), cut to 2 folds,
# 2 epochs and 1 augmentation per image, over resnet34/resnet50 × attention
# on/off at batch 4, on the data phase's directory of TIFFs.
GRID_OPTIONS = {"backbone": ["resnet34", "resnet50"],
                "use_attention": [True, False], "batch_size": [4]}
GRID_BASE = {"name": "Model Configuration Test", "num_epochs": 50,
             "learning_rate": 1e-3, "weight_decay": 1e-8, "pretrained": True,
             "early_stopping_patience": 5, "early_stopping_min_delta": 0.001,
             "verbose": True, "save_plots": False, "image_type": "W",
             "test_size": 0.3, "n_splits": 5, "random_state": 41,
             "augmentations_per_image": 10, "img_size": (128, 128),
             "loss_fn": "bce"}
GRID_CUTS = {"n_splits": 2, "num_epochs": 2, "augmentations_per_image": 1}


def phase_encoders(device="cuda", batch=BATCH, size=SIZE) -> dict:
    """(j): each of ENCODER_MODELS serves one request through its kernel
    (``phase_serving``: launches per forward, probabilities and logits
    against the f32 model without kernels, alternated forward medians,
    peak memory), then every gate and upsample call those forwards make,
    against its plain version in f32 and bf16 (B=16), kept apart from the
    flagship's sums. Returns the ``encoders`` line's dict."""
    from segtpu_torch.kernels.attention_gate import (attention_gate,
                                                     attention_gate_plain)
    from segtpu_torch.kernels.fused_conv import (upsample2x_concat,
                                                 upsample2x_concat_plain)
    served = []
    launches = {"attention_gate": 0, "upsample2x_concat": 0}
    for backbone, att in ENCODER_MODELS:
        r = phase_serving(att, device, batch, size, ENCODER_REQUESTS,
                          backbone=backbone, turns=ENCODER_TURNS,
                          tag="encoder-serving", over_bf16=True)
        # the request's launches, counted as the flagship's
        launches["attention_gate" if att else "upsample2x_concat"] += \
            r["launches"]
        served.append({k: r[k] for k in (
            "backbone", "model", "launches", "launches_per_forward",
            "kernel_shapes", "forward_ms_kernels", "forward_ms_plain",
            "forward_ms_kernels_turns", "forward_ms_plain_turns",
            "img_per_s_kernels", "img_per_s_plain", "max_memory_gib",
            "probs_max_abs_err", "logits_max_abs_err", "logits_max_abs",
            "probs_max_abs_err_bf16_plain", "logits_max_abs_err_bf16_plain",
            "profile_busy_share", "profile_port_kernels_ms") if k in r})
    gen = torch.Generator(device=device).manual_seed(SEED)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=device)
    sums = {}
    for r in served:
        name, kernel, plain, case = (
            ("attention_gate", attention_gate, attention_gate_plain,
             _gate_case) if r["model"] == "attention" else
            ("upsample2x_concat", upsample2x_concat,
             upsample2x_concat_plain, _upsample_case))
        recs = _kernel_records(name, kernel, plain, case,
                               [tuple(t) for t in r["kernel_shapes"]], gen,
                               flush, device)
        total = {k: sum(x[k] for x in recs) for k in (
            "ms", "plain_ms", "bound_ms")}
        lib = [x["library_ms"] for x in recs]
        total["library_ms"] = None if None in lib else sum(lib)
        if name == "attention_gate":
            total["composition_ms"] = sum(x["composition_ms"] for x in recs)
        total["max_abs_err"] = max(x["max_abs_err"] for x in recs)
        total["bound_by"] = max(recs, key=lambda x: x["bound_ms"])[
            "bound_by"]
        total["shapes"] = [x["shape"] for x in recs]
        sums.setdefault(r["backbone"], {})[name] = total
    res = dict(batch=batch, size=size, dtype="bfloat16", models=served,
               launches=launches, kernels_bf16=sums)
    print("encoders " + json.dumps(res), flush=True)
    return res


def torchvision_state_dict(backbone: str, gen: torch.Generator) -> dict:
    """A ``state_dict`` with torchvision's key names and shapes for
    ``backbone`` (RGB stem, classifier head), random weights from
    ``gen``, written out here apart from the port's converter."""
    sd = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = torch.randn(cout, cin, k, k, generator=gen) \
            / (cin * k * k) ** 0.5

    def bn(key, c):
        sd[f"{key}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{key}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(1000)

    if backbone == "densenet121":
        conv("features.conv0", 64, 3, 7)
        bn("features.norm0", 64)
        ch = 64
        for bi, n in enumerate((6, 12, 24, 16)):
            for li in range(n):
                k = f"features.denseblock{bi + 1}.denselayer{li + 1}"
                bn(f"{k}.norm1", ch + 32 * li)
                conv(f"{k}.conv1", 128, ch + 32 * li, 1)
                bn(f"{k}.norm2", 128)
                conv(f"{k}.conv2", 32, 128, 3)
            ch += 32 * n
            if bi < 3:
                bn(f"features.transition{bi + 1}.norm", ch)
                conv(f"features.transition{bi + 1}.conv", ch // 2, ch, 1)
                ch //= 2
        bn("features.norm5", ch)
        sd["classifier.weight"] = torch.randn(1000, ch, generator=gen)
        sd["classifier.bias"] = torch.zeros(1000)
        return sd
    bottleneck = backbone == "resnet50"
    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (w, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        cout = 4 * w if bottleneck else w
        for bi in range(n):
            k = f"layer{li + 1}.{bi}"
            if bottleneck:
                conv(f"{k}.conv1", w, cin, 1)
                conv(f"{k}.conv2", w, w, 3)
                conv(f"{k}.conv3", cout, w, 1)
                bn(f"{k}.bn3", cout)
            else:
                conv(f"{k}.conv1", w, cin, 3)
                conv(f"{k}.conv2", w, w, 3)
            bn(f"{k}.bn1", w)
            bn(f"{k}.bn2", w)
            if bi == 0 and cin != cout or (bi == 0 and li > 0):
                conv(f"{k}.downsample.0", cout, cin, 1)
                bn(f"{k}.downsample.1", cout)
            cin = cout
    sd["fc.weight"] = torch.randn(1000, cin, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _torchvision_key(key: str, backbone: str) -> str:
    """The torchvision key a port encoder key comes from."""
    if key == "input_conv.weight":
        return "features.conv0.weight" if backbone == "densenet121" \
            else "conv1.weight"
    return re.sub(r"^enc(\d)", r"layer\1", key)


def phase_pretrained(device="cuda", size=64) -> dict:
    """(k): for resnet50 and densenet121, a torchvision-format checkpoint
    file through ``Segmenter(config={"encoder_checkpoint": {backbone:
    path}})``: after ``fit`` with 0 epochs (no step), every encoder tensor
    on the card equals the file's bit for bit (the stem: the RGB kernel
    summed over its input channels), every other tensor the seed's fresh
    init; then ``load_pretrained_encoder`` the same way."""
    import os
    import tempfile
    from segtpu_torch.api import Segmenter
    rng = np.random.default_rng(SEED)
    imgs, masks = _blob_images(4, size, rng)
    res = {}
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-ckpt-") as root:
        for backbone in ("resnet50", "densenet121"):
            path = os.path.join(root, f"{backbone}.pth")
            file_sd = torchvision_state_dict(
                backbone, torch.Generator().manual_seed(SEED))
            torch.save(file_sd, path)
            cfg = {"img_size": (size, size), "batch_size": 2, "seed": SEED,
                   "verbose": False, "num_epochs": 0,
                   "encoder_checkpoint": {backbone: path,
                                          "resnet34": "absent.pth"}}
            t0 = time.perf_counter()
            seg = Segmenter(backbone=backbone, use_attention=True,
                            config=cfg, device=device)
            seg.fit(imgs, masks)
            fit_s = time.perf_counter() - t0
            fresh = seg.engine.init_state(
                torch.Generator().manual_seed(SEED), 1e-3, 1e-5).model
            want = fresh.state_dict()
            loaded = {}
            for k in want:
                tv = _torchvision_key(k, backbone)
                if k.endswith("num_batches_tracked") or tv not in file_sd:
                    continue
                src = file_sd[tv]
                loaded[k] = src.sum(dim=1, keepdim=True) \
                    if k == "input_conv.weight" else src
            want.update({k: v.to(device) for k, v in loaded.items()})
            for how, model in (("fit(encoder_checkpoint)", seg.state.model),
                               ("load_pretrained_encoder",
                                seg.load_pretrained_encoder(path)
                                .state.model)):
                got = model.state_dict()
                bad = [k for k, v in got.items()
                       if not (v.device.type == torch.device(device).type
                               and torch.equal(v, want[k]))]
                check(not bad and len(loaded) > 100,
                      f"pretrained (k): {backbone} {how}: {len(loaded)} "
                      f"encoder tensors equal the file's, the stem its RGB "
                      f"sum, the other {len(got) - len(loaded)} the seed's "
                      f"fresh init, on {device} (differing: {bad[:3]})")
            res[backbone] = dict(encoder_tensors=len(loaded),
                                 file_tensors=len(file_sd), fit_s=fit_s)
    print("pretrained " + json.dumps(res), flush=True)
    return res


def phase_grid(device="cuda", size=128) -> dict:
    """(l): ``ModelConfigurationExperiment`` over GRID_OPTIONS with
    GRID_BASE cut by GRID_CUTS, on the data phase's directory, then
    ``save_results``. Checks: finite CV and test IoUs, identical folds
    across configurations, JSON read back, every model on the card, and
    4 gate launches per validation forward of the attention
    configurations. Returns the ``grid`` line's dict."""
    import json as _json
    import os
    import tempfile
    from segtpu_torch.eval import cross_validation
    from segtpu_torch.experiments.model_configuration import \
        ModelConfigurationExperiment
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    calls = []
    real = cross_validation.train_model

    def recorded(**kw):
        t0 = time.perf_counter()
        out = real(**kw)
        torch.cuda.synchronize()
        cfg = kw["config"]
        calls.append(dict(
            name=cfg["name"], seed=cfg.get("seed"),
            attention=bool(cfg["use_attention"]),
            batch=int(cfg["batch_size"]),
            train=hash(kw["train_images"].tobytes()),
            val=hash(kw["val_images"].tobytes()),
            n_val=len(kw["val_images"]),
            epochs=len(out["val_metrics"]), seconds=time.perf_counter() - t0,
            on_device=all(p.device.type == torch.device(device).type
                          for p in out["state"].model.parameters())))
        return out

    with tempfile.TemporaryDirectory(prefix="segtpu-torch-grid-") as root:
        write_data_dir(root)
        base = dict(GRID_BASE, **GRID_CUTS, data_dir=root,
                    img_size=(size, size))
        cross_validation.train_model = recorded
        try:
            exp = ModelConfigurationExperiment(base, GRID_OPTIONS,
                                               device=device)
            reset_launch_counts()
            t0 = time.perf_counter()
            results = exp.run_model_comparison()
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            cross_validation.train_model = real
        out_dir = os.path.join(root, "out")
        exp.save_results(out_dir)
        with open(os.path.join(
                out_dir, "model_configuration_results.json")) as f:
            back = _json.load(f)
        with open(os.path.join(
                out_dir, "model_configuration_summary.json")) as f:
            summary = _json.load(f)
    names = [c["name"] for c in exp.model_configs]
    cv = results["cv_results"]["comparison_summary"]
    gen = results["generalization_results"]
    finite = all(np.isfinite([cv[n]["iou_mean"], cv[n]["iou_std"],
                              gen[n]["test_metrics"]["iou"]]).all()
                 for n in names)
    check(finite and sorted(cv) == sorted(names) == sorted(gen),
          f"grid (l): {len(names)} configurations, CV iou_mean/iou_std and "
          f"test IoU finite {finite}")
    k = GRID_CUTS["n_splits"]
    per = {n: [c for c in calls if c["name"] == n] for n in names}
    folds = {n: [(c["train"], c["val"]) for c in cs[:k]]
             for n, cs in per.items()}
    same = all(len(cs) == k + 1 for cs in per.values()) and len(
        set(map(tuple, folds.values()))) == 1
    check(same, f"grid (l): every configuration trained {k} CV folds and "
          f"one held-out run, on identical folds: {same}")
    check(all(c["on_device"] for c in calls) and len(calls) > 0,
          f"grid (l): every model of the {len(calls)} trainings on {device}")
    check(set(back) == {"cv_results", "generalization_results",
                        "model_configs", "configuration_options"}
          and summary["total_configurations_tested"] == len(names)
          and summary["best_cv_config"] is not None,
          "grid (l): model_configuration_results.json and _summary.json "
          "read back with their keys")
    want_gate = sum(4 * c["epochs"] * -(-c["n_val"] // c["batch"])
                    for c in calls if c["attention"])
    check(counts["attention_gate"] == want_gate,
          f"grid (l): attention_gate launched {counts['attention_gate']} "
          f"times, want 4 per validation forward of the attention "
          f"configurations: {want_gate}")
    res = dict(
        configurations=names, cuts=GRID_CUTS, img_size=[size, size],
        total_s=total_s,
        seconds_per_configuration={n: sum(c["seconds"] for c in cs)
                                   for n, cs in per.items()},
        seconds_per_fold={n: [c["seconds"] for c in cs[:k]]
                          for n, cs in per.items()},
        seconds_held_out={n: cs[k]["seconds"] for n, cs in per.items()
                          if len(cs) > k},
        cv_iou={n: [cv[n]["iou_mean"], cv[n]["iou_std"]] for n in names},
        test_iou={n: gen[n]["test_metrics"]["iou"] for n in names},
        launches=counts, gate_launches_expected=want_gate,
        clock="host s, synchronised")
    print("grid " + json.dumps(res), flush=True)
    return res


# (m): fold-parallel CV, forward selection and observability on the data
# phase's TIFFs. (m1): the grid's resnet34 attention configuration (its
# base config cut by GRID_CUTS), sequential, then fold-parallel with each
# strategy, cuDNN deterministic in all three so that only the strategy
# tells them apart. (m2): the forward-selection driver's base config
# (segtpu_torch/experiments/forward_selection.py), cut to 2 candidates, one
# round, 3 grouped folds and 2 epochs, sequential and fold-parallel.
FOLD_CONFIG = dict(GRID_BASE, **GRID_CUTS, name="fold-parallel",
                   backbone="resnet34", use_attention=True, batch_size=4)
FOLD_STRATEGIES = ("stream", "vmap")
TOL_FOLDS = 1e-2       # the JAX package's bar (tests/test_fold_parallel.py)
# one (m1) fold's training images (14 originals, 1 augmentation each) and
# validation images, for the profiled epoch
FOLD_SIZES = (28, 14)
SELECTION_CANDIDATES = ("horizontal_flip", "random_crop")
SELECTION_OVERRIDES = {"num_epochs": 2}
SELECTION_FOLDS = 3


class _EvalForwards:
    """Records the batch size and model of every validation forward
    (``TrainEngine._eval_step_vec``) while it is entered."""

    def __enter__(self):
        from segtpu_torch.train.engine import TrainEngine
        self.calls, self._real = [], TrainEngine._eval_step_vec
        real, calls = self._real, self.calls

        def recorded(engine, state, images, masks):
            calls.append((images.shape[0], state.model))
            return real(engine, state, images, masks)

        TrainEngine._eval_step_vec = recorded
        return self

    def __exit__(self, *exc):
        from segtpu_torch.train.engine import TrainEngine
        TrainEngine._eval_step_vec = self._real


def _observed_fold(real_train_model, root):
    """``train_model`` that gives its first call ``metrics_log`` and
    ``tensorboard_dir`` under ``root`` (check (m3))."""
    import os
    seen = []

    def run(**kw):
        if not seen:
            kw["config"] = dict(kw["config"],
                                metrics_log=os.path.join(root, "m.jsonl"),
                                tensorboard_dir=os.path.join(root, "tb"))
        out = real_train_model(**kw)
        seen.append(out)
        return out
    return run, seen


def _check_logs(root, result) -> dict:
    """(m3): one JSONL record and one TensorBoard event per epoch, each
    with that epoch's metrics, every record parsed."""
    import os
    from segtpu_torch.core.tboard import read_scalar_events
    recs = [json.loads(line) for line in open(os.path.join(root, "m.jsonl"))]
    (name,) = os.listdir(os.path.join(root, "tb"))
    events = list(read_scalar_events(os.path.join(root, "tb", name)))
    epochs = len(result["val_metrics"])
    same = all(
        r["kind"] == "epoch" and r["epoch"] == e
        and all(r[f"val_{k}"] == v for k, v in vm.items())
        and all(r[f"train_{k}"] == v for k, v in tm.items())
        and ev[1] == e and abs(ev[2]["val/iou"] - vm["iou"]) <= 1e-6
        for e, (r, ev, vm, tm) in enumerate(zip(
            recs, events, result["val_metrics"], result["train_metrics"])))
    check(len(recs) == len(events) == epochs and same,
          f"folds (m3): {len(recs)} JSONL records and {len(events)} "
          f"TensorBoard events for {epochs} epochs, each the epoch's "
          f"metrics: {same}")
    return dict(jsonl_records=len(recs), tb_events=len(events))


def _check_trace(model, images, device) -> dict:
    """(m3): ``core.profiling.trace`` around one validation forward
    writes a trace file that names the gate kernel."""
    import os
    import tempfile
    from segtpu_torch.core.hlo_profile import PORT_KERNELS
    from segtpu_torch.core.profiling import annotate, trace
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-trace-") as d:
        with trace(d), annotate("validation-forward"), \
                torch.inference_mode():
            model.eval()(images.to(device))
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        text = open(os.path.join(d, name)).read()
        size = os.path.getsize(os.path.join(d, name))
    named = [k for k in PORT_KERNELS if "gate" in k and k in text]
    check(bool(named) and "validation-forward" in text,
          f"folds (m3): the trace of a validation forward ({size} bytes) "
          f"names the gate kernel ({named}) and the annotation")
    return dict(trace_bytes=size, trace_gate_kernels=named)


def _fold_gates_vs_plain(forwards, gates, cfg) -> dict:
    """(m1): every gate call of one fold-parallel CV's validation
    forwards (f32, at (m1)'s batch and at the validation set's remainder
    batch, on the four levels at 128², 8² to 64²) against the plain
    version on the same inputs, within TOL_F32 of the output's scale."""
    shapes, errs, shares = gates.against_plain(TOL_F32)
    share = max(shares, default=float("inf"))
    batches = sorted({b for b, _ in forwards})
    f32 = all(out.dtype == torch.float32 for _, out in gates.calls)
    n = len(gates.calls)
    ok = n == 4 * len(forwards) > 0 and f32 and len(batches) == 2 \
        and share <= 1.0
    worst = {}
    for s, e in zip(shapes, errs):
        worst[str(s)] = max(e, worst.get(str(s), 0.0))
    check(ok, f"folds (m1): attention_gate at {n} calls of "
          f"{len(forwards)} validation forwards (batches {batches}; want "
          f"the batch size and a remainder), f32 {f32}, against the plain "
          f"version: worst {share:.3g} of the tolerance ({TOL_F32} of "
          f"each output's scale); (B, H, W, Cg, Cx, F): max_abs_err {worst}")
    gates.calls.clear()     # else the copies count in the timed runs' peak
    return dict(gate_vs_plain_calls=n, gate_vs_plain_batches=batches,
                gate_vs_plain_max_abs_err=worst,
                gate_vs_plain_tol_share=share)


# (m1)'s float32 stacked-step check, TF32 off (``main`` turns it off for
# the whole run). The forward and backward of every fold
# under vmap against the fold's own model, from the same weights and
# batch: vmap's grouped convolutions sum in another order, so a fold's
# loss within 1e-3 of itself; the gradients carry that reordering through
# the BatchNorms' backward, whose sums cancel heavily this early in
# training (the same check at this config on the CPU, float32: up to
# 1.2e-2 of a tensor's gradient norm), so each tensor's gradient within
# 0.1 of its norm (floored at 1e-2 of the largest tensor's). A fault of
# the strategy (another fold's statistics or weights, a wrong layout)
# moves a loss or a tensor's gradient by order 1. The BatchNorms' running
# statistics, moved by 0.1 of batch statistics that carry the reordering:
# within 1e-3 of their norm. The functional optimizer and the fold's torch
# optimizer given the same gradients compute the same update in another
# order: weights within 1e-6 of their scale. Validation probabilities of
# the strategy's evaluation model (one model, loaded fold by fold, its
# gates refolded) against each fold's own model holding the same weights:
# both run the same kernels on weights 1e-6 apart, so TOL_F32.
TOL_STACKED_F32 = dict(loss=1e-3, grad=1e-1, stats=1e-3, weights=1e-6,
                       probs=TOL_F32)


def _norm_rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ over the tensor lists ``a`` and ``b`` together."""
    num = sum(float((x - y).double().square().sum()) for x, y in zip(a, b))
    return (num / sum(float(y.double().square().sum()) for y in b)) ** 0.5


def _f32_stacked_step(cfg, device) -> dict:
    """(m1): ``vmap``'s float32 training step (``_stacked_step``) and
    validation model against each fold's own, at (m1)'s config: two
    steps at its batch size, one learning rate per fold, then validation
    forwards at the batch size and a remainder of 2; bars
    TOL_STACKED_F32."""
    from segtpu_torch.train import engine as engine_mod
    from segtpu_torch.train.optim import set_learning_rate
    dev = torch.device(device)
    engine = engine_mod.get_engine(cfg, device=device)
    k, lr, wd = cfg["n_splits"], cfg["learning_rate"], cfg["weight_decay"]
    lrs = [lr / (f + 1) for f in range(k)]
    states = [engine.init_state(torch.Generator().manual_seed(SEED + 1000 * f),
                                lrs[f], wd) for f in range(k)]
    stack = engine.stack_folds(states, wd)
    grads, real_step = [], engine_mod.functional_step

    def recorded(name, params, g, *a, **kw):
        grads.append({n: t.detach().clone() for n, t in g.items()})
        return real_step(name, params, g, *a, **kw)

    gen = torch.Generator(dev).manual_seed(SEED)
    s = cfg["img_size"][0]
    loss_at = engine_mod.METRIC_KEYS.index("loss")
    err = dict.fromkeys(TOL_STACKED_F32, 0.0)

    engine_mod.functional_step = recorded
    try:
        for b in (cfg["batch_size"],) * 2:
            x = torch.rand(k, b, 1, s, s, generator=gen, device=dev)
            y = (x > 0.7).float()
            own = []
            for f, st in enumerate(states):
                st.model.train()
                st.optimizer.zero_grad(set_to_none=True)
                own.append(float(engine._micro_step(st.model, x[f], y[f],
                                                    1.0)[loss_at]))
            vec = engine._stacked_step(stack, x, y, torch.tensor(
                lrs, dtype=torch.float64, device=dev))
            for f, st in enumerate(states):
                err["loss"] = max(err["loss"], abs(float(vec[f, loss_at])
                                                   - own[f]) / abs(own[f]))
                named = dict(st.model.named_parameters())
                floor = 1e-2 * max(float(p.grad.norm())
                                   for p in named.values())
                err["grad"] = max(err["grad"], max(
                    float((grads[-1][n][f] - p.grad).norm())
                    / max(float(p.grad.norm()), floor)
                    for n, p in named.items()))
                # the optimizer check: the fold's own optimizer steps on the
                # gradients the stacked step used
                for n, p in named.items():
                    p.grad = grads[-1][n][f].clone()
                set_learning_rate(st.optimizer, lrs[f])
                st.optimizer.step()
        val = torch.rand(k, 6, 1, s, s, generator=gen, device=dev)
        _f32_fold_models(engine, stack, states, val, err)
    finally:
        engine_mod.functional_step = real_step
    check(all(err[n] <= TOL_STACKED_F32[n] for n in err),
          f"folds (m1): vmap's float32 step vs each fold's own (B = "
          f"{cfg['batch_size']}, two steps; TF32 "
          f"{torch.backends.cudnn.allow_tf32}): "
          + ", ".join(f"{n} {err[n]:.3g} (tol {TOL_STACKED_F32[n]})"
                      for n in err))
    return dict(f32_stacked_step_err=err)


def _f32_fold_models(engine, stack, states, val, err) -> None:
    """Part of ``_f32_stacked_step``: each fold's running statistics and
    weights in the stack against its own model's, then validation
    probabilities (batches of 4 and 2) of ``stack.eval_model`` loaded
    with the fold against the fold's model given the same statistics;
    the largest errors into ``err``."""
    if stack.eval_model is None:
        stack.eval_model = engine.build_model()
    for f, st in enumerate(states):
        bufs = {n: t for n, t in st.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}
        err["stats"] = max(err["stats"], _norm_rel(
            [stack.buffers[n][f] for n in bufs], list(bufs.values())))
        named = dict(st.model.named_parameters())
        scale = max(float(p.detach().abs().max()) for p in named.values())
        err["weights"] = max(err["weights"], max(
            float((stack.params[n][f] - p.detach()).abs().max())
            for n, p in named.items()) / scale)
        with torch.no_grad():                 # the same statistics too
            for n, t in bufs.items():
                t.copy_(stack.buffers[n][f])
        probs = []
        for model in (engine.load_fold(stack, f, stack.eval_model),
                      st.model):
            model.eval()
            with torch.no_grad(), engine.autocast():
                probs.append(torch.cat([torch.sigmoid(model(v).float())
                                        for v in val[f].split(4)]))
        err["probs"] = max(err["probs"],
                           float((probs[0] - probs[1]).abs().max()))


def _fold_epoch_profile(cfg, device) -> dict:
    """One fold's epoch (``run_fold_epoch_async``: training epoch and
    validation pass, enqueued with no fetch) at (m1)'s sizes, profiled
    twice after one unprofiled call: the device's busy share of the
    span, so 1 − busy is the share in which the card waited for the
    host."""
    from segtpu_torch.train.engine import get_engine
    dev = torch.device(device)
    engine = get_engine(cfg, device=device)
    state = engine.init_state(torch.Generator().manual_seed(SEED),
                              cfg["learning_rate"], cfg["weight_decay"])
    gen = torch.Generator(dev).manual_seed(SEED)
    s = cfg["img_size"][0]
    n_train, n_val = FOLD_SIZES
    ti = torch.rand(n_train, 1, s, s, generator=gen, device=dev)
    vi = torch.rand(n_val, 1, s, s, generator=gen, device=dev)
    tm, vm = (ti > 0.7).float(), (vi > 0.7).float()
    prof = _profile_calls(lambda: engine.run_fold_epoch_async(
        state, ti, tm, vi, vm, cfg["learning_rate"], gen,
        cfg["batch_size"]), 2)
    return dict(train_images=n_train, val_images=n_val,
                busy_share=prof["profile_busy_share"],
                busy_ms=prof["profile_busy_ms"],
                port_kernels_ms=prof["profile_port_kernels_ms"],
                top=prof["profile_top"])


def _float64_folds(validator, cfg, device) -> dict:
    """(m1): the ``stream`` and the ``vmap`` strategy on the same folds,
    the same augmented frames and seeds, in float64 on the card (without
    the gate kernel, which takes f32 and bf16): the two must compute the
    same training, weights within 1e-9 of their scale, the same LR
    histories and best epochs, per-epoch metrics within 1e-5 (float32
    totals). In float32 only the losses can be held together: both
    strategies round differently (grouped convolutions), and Adam's
    first, sign-like steps on near-zero gradients turn that into weights
    that differ where they do not move the loss."""
    from segtpu_torch.data.augment import CellAugmenter
    from segtpu_torch.eval import fold_parallel as fp
    from segtpu_torch.train.engine import get_engine
    from segtpu_torch.train.loop import _materialize
    ci, cm = validator._canonical(cfg["img_size"])
    arrays, seeds = [], []
    for k, (tr, va) in enumerate(validator.create_cv_folds()):
        seed = int(cfg.get("seed", 0)) + 1000 * k
        ti, tm = CellAugmenter(cfg["augmentations_per_image"], seed=seed,
                               device=device).augment_training_data(
            ci[tr], cm[tr])
        arrays.append(tuple(t.double() for t in _materialize(
            ti, tm, device=device) + _materialize(ci[va], cm[va],
                                                  device=device)))
        seeds.append(seed)
    f64 = dict(cfg, fuse_gate=False)
    engine = get_engine(f64, device=device)
    build = engine.build_model
    engine.build_model = lambda: build().double()
    out, secs = {}, {}
    for strategy in FOLD_STRATEGIES:
        t0 = time.perf_counter()
        out[strategy] = fp.train_folds_parallel(
            arrays, f64, engine=engine, seeds=seeds, strategy=strategy,
            device=device)
        torch.cuda.synchronize()
        secs[strategy] = time.perf_counter() - t0

    def rel(a, b):
        keys = [n for n, t in a.items() if t.is_floating_point()]
        scale = max(float(a[n].abs().max()) for n in keys)
        return max(float((a[n] - b[n]).abs().max()) for n in keys) / scale

    w_err = max(rel(s_["state"].model.state_dict(),
                    v_["state"].model.state_dict())
                for s_, v_ in zip(out["stream"], out["vmap"]))
    m_err = max(abs(sm[key] - vm[key])
                for s_, v_ in zip(out["stream"], out["vmap"])
                for part in ("train_metrics", "val_metrics")
                for sm, vm in zip(s_[part], v_[part]) for key in sm)
    same = all(s_["lr_history"] == v_["lr_history"]
               and s_["best_epoch"] == v_["best_epoch"]
               and len(s_["val_metrics"]) == len(v_["val_metrics"])
               for s_, v_ in zip(out["stream"], out["vmap"]))
    double = all(p.dtype == torch.float64 for r in out["vmap"]
                 for p in r["state"].model.parameters())
    check(same and double and w_err <= 1e-9 and m_err <= 1e-5,
          f"folds (m1): vmap equals stream in float64 on {device}: weights "
          f"{w_err:.3g} of their scale, metrics {m_err:.3g}, the same LR "
          f"histories and best epochs: {same}")
    return dict(weights_rel_err=w_err, metrics_err=m_err, seconds=secs,
                val_iou={s_: [[m["iou"] for m in r["val_metrics"]]
                              for r in o] for s_, o in out.items()})


def phase_folds(device="cuda", size=128) -> dict:
    """(m1) and (m3): ``CrossValidator`` on the data phase's TIFFs,
    sequential (its first fold with ``metrics_log`` and
    ``tensorboard_dir``), then ``fold_parallel=True`` with ``stream`` and
    with ``vmap``. Checks: each fold's final IoU and loss within TOL_FOLDS
    of the sequential run's (``vmap``: of ``stream``'s), one fetch per
    ``stream`` window (one per epoch under ``vmap``), exactly 4 gate
    launches per validation forward, every fold's model on the card, the
    logs and the trace. Returns the ``folds`` line's dict."""
    import tempfile
    from segtpu_torch.eval import cross_validation
    from segtpu_torch.eval import fold_parallel as fp
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device(device)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    runs, res = {}, {}
    real_train, real_cv = (cross_validation.train_model,
                           cross_validation.cv_train_folds_parallel)
    real_window = fp.dispatch_window
    try:
        with tempfile.TemporaryDirectory(prefix="segtpu-torch-folds-") as root:
            write_data_dir(root)
            cfg = dict(FOLD_CONFIG, data_dir=root, img_size=(size, size))
            # untimed: the first CV at these shapes (cuDNN's deterministic
            # choices, first allocations), run by ``stream``, every gate
            # call of its validation forwards recorded
            with _EvalForwards() as fwd, _GateCalls() as gates:
                cross_validation.CrossValidator(
                    root, "W", n_splits=cfg["n_splits"],
                    random_state=cfg["random_state"],
                    augmentations_per_image=cfg["augmentations_per_image"],
                    verbose=False, fold_parallel=True,
                    device=device).cross_validate_single_model(
                        None, dict(cfg, fold_parallel_strategy="stream"))
            res.update(_fold_gates_vs_plain(fwd.calls, gates, cfg))
            for mode in ("sequential",) + FOLD_STRATEGIES:
                par = mode != "sequential"
                v = cross_validation.CrossValidator(
                    root, "W", n_splits=cfg["n_splits"],
                    random_state=cfg["random_state"],
                    augmentations_per_image=cfg["augmentations_per_image"],
                    verbose=False, fold_parallel=par, device=device)
                outs, windows = [], []

                def cv_recorded(*a, **kw):
                    out = real_cv(*a, **kw)
                    outs.extend(out)
                    return out

                def window_counted(*a, **kw):
                    windows.append(a[5])
                    return real_window(*a, **kw)

                if par:
                    cross_validation.cv_train_folds_parallel = cv_recorded
                    fp.dispatch_window = window_counted
                else:
                    cross_validation.train_model, outs = _observed_fold(
                        real_train, root)
                v._canonical(cfg["img_size"])    # decoded before the clock
                fp.reset_fetch_count()
                reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with _EvalForwards() as fwd:
                    t0 = time.perf_counter()
                    r = v.cross_validate_single_model(None, dict(
                        cfg, fold_parallel_strategy=mode))
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                cross_validation.train_model = real_train
                cross_validation.cv_train_folds_parallel = real_cv
                fp.dispatch_window = real_window
                epochs = sum(len(o["val_metrics"]) for o in outs)
                runs[mode] = dict(
                    result=r, outs=outs, seconds=secs, epochs=epochs,
                    fetches=fp.fetch_count(), windows=windows,
                    forwards=len(fwd.calls),
                    gate=launch_counts()["attention_gate"],
                    upsample=launch_counts()["upsample2x_concat"],
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
                if mode == "sequential":
                    res.update(_check_logs(root, outs[0]))
            res["epoch_profile"] = _fold_epoch_profile(cfg, device)
            res["float64"] = _float64_folds(v, cfg, device)
            res.update(_f32_stacked_step(cfg, device))
            model = runs["stream"]["outs"][0]["state"].model
            images = torch.rand(cfg["batch_size"], 1, size, size,
                                generator=torch.Generator().manual_seed(
                                    SEED)).contiguous(
                memory_format=torch.channels_last)
            res.update(_check_trace(model, images, dev))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        cross_validation.train_model = real_train
        cross_validation.cv_train_folds_parallel = real_cv
        fp.dispatch_window = real_window

    k = cfg["n_splits"]
    folds = {m: run["result"]["fold_results"] for m, run in runs.items()}
    err = max(abs(a[key] - b[key]) for a, b in zip(folds["stream"],
                                                   folds["sequential"])
              for key in ("iou", "loss"))
    check(len(folds["stream"]) == k and err <= TOL_FOLDS,
          f"folds (m1): stream's {k} folds' final IoU and loss within "
          f"{TOL_FOLDS} of sequential's: max error {err:.3g}")
    res["max_err_stream_vs_sequential"] = err
    # vmap against stream: in float32, every epoch's training and
    # validation loss; the thresholded metrics are reported, and the two
    # strategies are held to each other in float64 (_float64_folds)
    pairs = [(s_, v_) for so, vo in zip(runs["stream"]["outs"],
                                        runs["vmap"]["outs"])
             for key in ("train_metrics", "val_metrics")
             for s_, v_ in zip(so[key], vo[key])]
    loss_err = max(abs(s_["loss"] - v_["loss"]) for s_, v_ in pairs)
    check(len(runs["vmap"]["outs"]) == k and len(pairs) == 2 * runs[
        "stream"]["epochs"] and loss_err <= TOL_FOLDS,
          f"folds (m1): vmap's per-epoch training and validation losses, "
          f"float32, within {TOL_FOLDS} of stream's: max error "
          f"{loss_err:.3g}")
    res["max_loss_err_vmap_vs_stream"] = loss_err
    res["max_metric_err_vmap_vs_stream"] = {
        key: max(abs(s_[key] - v_[key]) for s_, v_ in pairs)
        for key in ("iou", "f1", "precision", "recall", "accuracy")}
    for mode, run in runs.items():
        on_card = all(p.device.type == dev.type for o in run["outs"]
                      for p in o["state"].model.parameters())
        check(len(run["outs"]) == k and on_card,
              f"folds (m1): {mode}: every one of {len(run['outs'])} fold "
              f"models on {device}")
        check(run["gate"] == 4 * run["forwards"] > 0
              and run["upsample"] == 0,
              f"folds (m1): {mode}: attention_gate launched {run['gate']} "
              f"times, 4 per validation forward of {run['forwards']}; "
              f"upsample {run['upsample']} (no level fused at {size}², "
              f"B={cfg['batch_size']})")
    for mode in FOLD_STRATEGIES:
        run = runs[mode]
        want = len(run["windows"]) if mode == "stream" else \
            max(len(o["val_metrics"]) for o in run["outs"])
        check(run["fetches"] == want > 0,
              f"folds (m1): {mode}: {run['fetches']} device→host fetches, "
              f"one per {'window' if mode == 'stream' else 'epoch'}: "
              f"{want} (windows {run['windows']})")
    res.update(
        config={k2: cfg[k2] for k2 in ("backbone", "use_attention",
                                       "batch_size", "img_size", "loss_fn",
                                       "n_splits", "num_epochs",
                                       "augmentations_per_image",
                                       "random_state")},
        cudnn_deterministic=True,
        seconds_per_cv={m: r["seconds"] for m, r in runs.items()},
        seconds_per_fold={m: r["seconds"] / k for m, r in runs.items()},
        seconds_per_epoch={m: r["seconds"] / max(r["epochs"], 1)
                           for m, r in runs.items()},
        fold_epochs={m: r["epochs"] for m, r in runs.items()},
        fetches={m: r["fetches"] for m, r in runs.items()},
        windows=runs["stream"]["windows"],
        validation_forwards={m: r["forwards"] for m, r in runs.items()},
        peak_gib={m: r["peak_gib"] for m, r in runs.items()},
        fold_iou={m: [f["iou"] for f in fs] for m, fs in folds.items()},
        launches={"attention_gate": sum(r["gate"] for r in runs.values()),
                  "upsample2x_concat": sum(r["upsample"]
                                           for r in runs.values())},
        clock="host s, synchronised")
    print("folds " + json.dumps(res), flush=True)
    return res


def phase_selection(device="cuda", size=128) -> dict:
    """(m2): ``run_augmentation_selection_experiment`` with the driver's
    base config cut by SELECTION_*, sequential and fold-parallel, on the
    data phase's TIFFs. Checks: grouped folds with no base name on both
    sides, ``results.json`` read back with the reference's keys, scores
    finite in [0, 1], 3 sets × 3 folds trainings per mode, every model
    on the card, and the upsample launches ``_fused_level`` predicts for
    the validation forwards' batches. Returns the ``selection`` line's
    dict."""
    import os
    import tempfile
    from segtpu_torch.eval import fold_parallel as fp
    from segtpu_torch.experiments import forward_selection as fs
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device(device)
    real = (fs.AUGMENTATION_CANDIDATES, fs.group_kfold_split,
            fs.get_engine, fp.train_folds_parallel)
    res = {}
    try:
        fs.AUGMENTATION_CANDIDATES = {
            k: v for k, v in real[0].items() if k in SELECTION_CANDIDATES}
        with tempfile.TemporaryDirectory(prefix="segtpu-torch-sel-") as root:
            write_data_dir(root)
            for par in (False, True):
                mode = "fold_parallel" if par else "sequential"
                folds, engines, trained, sets = [], [], [], []

                def grouped(names, k):
                    out = real[1](names, k)
                    folds.append((list(names), out))
                    return out

                def engine_of(config, **kw):
                    e = real[2](config, **kw)
                    engines.append(e)
                    return e

                def parallel(arrays, config, **kw):
                    out = real[3](arrays, config, **kw)
                    trained.extend(out)
                    return out

                fs.group_kfold_split, fs.get_engine = grouped, engine_of
                fp.train_folds_parallel = parallel
                reset_launch_counts()
                torch.cuda.synchronize()
                save = os.path.join(root, mode)
                with _EvalForwards() as fwd:
                    t0 = time.perf_counter()
                    results, _ = fs.run_augmentation_selection_experiment(
                        data_dir=root, config_overrides=dict(
                            SELECTION_OVERRIDES, fold_parallel=par),
                        max_augmentations=1, cv_folds=SELECTION_FOLDS,
                        quick_evaluation=False, save_root=save,
                        device=device)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                fs.group_kfold_split, fs.get_engine = real[1], real[2]
                fp.train_folds_parallel = real[3]
                counts = launch_counts()
                with open(os.path.join(save, "augmentation_selection_results",
                                       "results.json")) as f:
                    back = json.load(f)
                n_sets = 1 + len(SELECTION_CANDIDATES)
                leak = [set(names[i] for i in tr) & set(names[i] for i in va)
                        for names, fl in folds for tr, va in fl]
                check(len(folds) == n_sets and not any(leak)
                      and all(len(fl) == SELECTION_FOLDS for _, fl in folds),
                      f"selection (m2): {mode}: {len(folds)} sets, each "
                      f"{SELECTION_FOLDS} grouped folds with no base name "
                      f"in train and validation")
                scores = [back["baseline_score"], back["final_score"]] + [
                    s for h in back["selection_history"]
                    for s in h["candidate_scores"].values()]
                check(set(back) == {"selected_augmentations", "final_score",
                                    "baseline_score", "total_improvement",
                                    "selection_history", "config"}
                      and all(np.isfinite(scores))
                      and all(0.0 <= s <= 1.0 for s in scores),
                      f"selection (m2): {mode}: results.json read back "
                      f"with the reference's keys, scores finite in "
                      f"[0, 1]: {[round(s, 4) for s in scores]}")
                n_train = len(trained) if par else len(engines)
                check(n_train == n_sets * SELECTION_FOLDS,
                      f"selection (m2): {mode}: {n_train} trainings, "
                      f"{n_sets} sets × {SELECTION_FOLDS} folds")
                # sequential: each fold's model is built by its engine
                on_card = all(e.device.type == dev.type for e in engines) \
                    and all(p.device.type == dev.type for o in trained
                            for p in o["state"].model.parameters())
                check(on_card, f"selection (m2): {mode}: every model on "
                      f"{device}")
                want_ups = sum(len(decoder_shapes(m, b, size)[1])
                               for b, m in fwd.calls)
                check(counts["upsample2x_concat"] == want_ups
                      and counts["attention_gate"] == 0,
                      f"selection (m2): {mode}: upsample launched "
                      f"{counts['upsample2x_concat']} times, as "
                      f"_fused_level predicts for {len(fwd.calls)} "
                      f"validation forwards: {want_ups}")
                per_fold = secs / (n_sets * SELECTION_FOLDS)
                res[mode] = dict(
                    seconds=secs, seconds_per_set=secs / n_sets,
                    seconds_per_fold=per_fold, trainings=n_train,
                    validation_forwards=len(fwd.calls),
                    selected=back["selected_augmentations"],
                    baseline_score=back["baseline_score"],
                    final_score=back["final_score"],
                    launches=counts)
    finally:
        (fs.AUGMENTATION_CANDIDATES, fs.group_kfold_split, fs.get_engine,
         fp.train_folds_parallel) = real
    res.update(candidates=list(SELECTION_CANDIDATES),
               cv_folds=SELECTION_FOLDS, **SELECTION_OVERRIDES,
               img_size=[size, size], clock="host s, synchronised",
               launches={k: sum(res[m]["launches"][k]
                                for m in ("sequential", "fold_parallel"))
                         for k in ("attention_gate", "upsample2x_concat")})
    print("selection " + json.dumps(res), flush=True)
    return res


# Phase (n): tiled and TTA inference, the serving export and the HTTP
# server, on the serving phase's random flagship weights (resnet34,
# attention, bf16 compute, f32 parameters). (n1) four synthetic slides of
# SLIDE² through the tiler: halo mode at overlap 32, the JAX package's
# serving preset (16 tiles of 544² per slide), and blend mode at tile 512,
# overlap 64 (25 tiles per slide).
SLIDE, SLIDES = 2048, 4
HALO_OVERLAP, BLEND_OVERLAP = 32, 64
# (n2): one predict_proba(tta=True) request of 16 images of 512².
TTA_IMAGES = 16
# (n3): the artifact answers these batches in a fresh process.
ARTIFACT_BATCHES = (1, 5, 16)
# (n3): the artifact against the live bf16 ``predict_proba`` on the same
# weights and inputs. The artifact applies its sigmoid to f32 logits (as
# the JAX package's serving graph does), the live path to bf16 logits,
# which rounds a probability by up to 2^-9; the rest is the same ops on
# the same card. 2^-8 holds that; an artifact that lost its autocast
# region (an f32 graph) differs from the live bf16 model by the whole
# bf16 error, which the check requires to exceed this bar.
TOL_ARTIFACT = 2.0 ** -8

# The deployment site of (n3): a fresh process in which
# ``segtpu_torch.models`` cannot be imported loads each artifact with
# ``ServingModel`` on the device, answers every batch saved beside it,
# counts the kernel launches per call, times the direct and the tiled
# path, and serves the first artifact over HTTP (tiled) to one batch and
# one slide. It writes the outputs as .npy files and prints one JSON line.
_DEPLOYMENT_SITE = r"""
import importlib.abc, io, json, sys, threading, time
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[:2] == ["segtpu_torch", "models"]:
            raise ImportError("blocked at the deployment site: " + name)
sys.meta_path.insert(0, _Block())
import numpy as np, torch
from segtpu_torch.infer.export import ServingModel
from segtpu_torch.infer.serve import client_predict, make_server
from segtpu_torch.kernels import launch_counts, reset_launch_counts
job = json.load(open(sys.argv[1]))
dev = job["device"]
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
out = {"models_imported": None, "artifacts": {}}
for name, spec in job["artifacts"].items():
    sm = ServingModel(spec["path"], device=dev)
    res = {"calls": []}
    for i, xpath in enumerate(spec["inputs"]):
        x = np.load(xpath)
        sm.predict_proba(x)          # warm-up
        sync()
        reset_launch_counts()
        y = sm.predict_proba(x)
        sync()
        res["calls"].append({"batch": int(x.shape[0]),
                             "launches": launch_counts()})
        np.save(spec["outputs"][i], y)
        if spec.get("time") and i == len(spec["inputs"]) - 1:
            t0 = time.perf_counter()
            for _ in range(3):
                sm.predict_proba(x)
            sync()
            res["img_per_s"] = 3 * x.shape[0] / (time.perf_counter() - t0)
    if spec.get("slide"):
        s = np.load(spec["slide"])
        sm.predict_proba_tiled(s)    # warm-up
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        y = sm.predict_proba_tiled(s)
        sync()
        dt = time.perf_counter() - t0
        res["tiled"] = {"launches": launch_counts(), "seconds": dt,
                        "mpix_per_s": s.shape[0] * s.shape[1] * s.shape[2]
                        / dt / 1e6}
        server = make_server(spec["path"], tiled=True, device=dev)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d" % server.server_address[1]
        try:
            x = np.load(spec["inputs"][-1])
            res["http_batch_equal"] = bool(np.array_equal(
                client_predict(url, x, timeout=600), sm.predict_proba(x)))
            res["http_slide_equal"] = bool(np.array_equal(
                client_predict(url, s, timeout=600), y))
        finally:
            server.shutdown()
            server.server_close()
    out["artifacts"][name] = res
out["models_imported"] = sorted(m for m in sys.modules
                                if m.startswith("segtpu_torch.models"))
print(json.dumps(out))
"""


def _flagship_segmenter(use_attention: bool, device, size):
    """A bf16 ``Segmenter`` (f32 parameters, bf16 autocast) holding the
    serving phase's random flagship weights."""
    from segtpu_torch.api import Segmenter
    from segtpu_torch.train.engine import TrainState
    seg = Segmenter(backbone="resnet34", use_attention=use_attention,
                    device=device,
                    config={"img_size": (size, size), "dtype": "bfloat16",
                            "seed": SEED})
    seg.state = TrainState(_randomized_flagship(use_attention, device,
                                                size=size))
    return seg


class _Forwards:
    """An NHWC ``apply_fn`` over ``model`` that counts its forwards."""

    def __init__(self, model):
        from segtpu_torch.infer.predict import nhwc_forward
        self.model, self.forward, self.batches = model, nhwc_forward, []

    def __call__(self, x):
        self.batches.append(x.shape[0])
        return self.forward(self.model, x.to(
            next(self.model.parameters()).dtype))


def _tiled_mode(seg, ref32, slides, mode, tile, overlap, device) -> dict:
    """(n1) for one mode: the four slides through
    ``make_tiled_predictor_many`` with the kernels (bf16) and without (f32
    model), MPix/s of the kernel run (host clock, synchronised, after a
    warm-up run), peak memory, gate launches per forward, and the
    probabilities and logits held to §2's serving bars."""
    from segtpu_torch.infer.tiled import make_tiled_predictor_many
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    model = seg.state.model
    x = torch.from_numpy(slides[..., None]).to(device)
    fwd = _Forwards(model)
    predict = make_tiled_predictor_many(fwd, tile=tile, overlap=overlap,
                                        mode=mode)
    with torch.inference_mode(), seg.engine.autocast():
        predict(x)                                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd.batches = []
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = predict(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        want = make_tiled_predictor_many(_Forwards(ref32), tile=tile,
                                         overlap=overlap, mode=mode)(x)
        # the bf16 model without its kernel: the error bf16 alone makes
        _use_kernels(model, False)
        with seg.engine.autocast():
            bf16 = make_tiled_predictor_many(_Forwards(model), tile=tile,
                                             overlap=overlap, mode=mode)(x)
        _use_kernels(model, True)
    scale = want.abs().max().item()
    lerr = (logits - want).abs().max().item()
    perr = (torch.sigmoid(logits) - torch.sigmoid(want)).abs().max().item()
    lerr_plain = (bf16 - want).abs().max().item()
    perr_plain = (torch.sigmoid(bf16) - torch.sigmoid(want)).abs().max() \
        .item()
    del bf16
    # §2's bars or, where bf16 alone misses them over all the slides,
    # TOL_KERNEL_OVER_BF16 times bf16's own error, as in (j)
    tol_p = max(TOL_PROBS, TOL_KERNEL_OVER_BF16 * perr_plain)
    tol_l = max(TOL_LOGITS_REL * scale, TOL_KERNEL_OVER_BF16 * lerr_plain)
    label = f"tiled (n1) {mode}"
    check(tuple(logits.shape) == tuple(x.shape)
          and bool(torch.isfinite(logits).all()),
          f"{label}: {len(slides)} slides of {slides.shape[1]}², finite, "
          f"shape {tuple(logits.shape)}")
    check(counts["attention_gate"] == 4 * len(fwd.batches) > 0
          and counts["upsample2x_concat"] == 0,
          f"{label}: {counts['attention_gate']} gate launches in "
          f"{len(fwd.batches)} forwards of {fwd.batches} tiles (want 4 per "
          f"forward), no other kernel ({counts})")
    check(perr <= tol_p and lerr <= tol_l,
          f"{label}: bf16 with kernels vs f32 without: probabilities "
          f"max_abs_err {perr:.3g} (tol {tol_p:.3g}), logits {lerr:.3g} "
          f"(tol {tol_l:.3g}, max|logit| {scale:.3g}); bf16 without "
          f"kernels {perr_plain:.3g} and {lerr_plain:.3g}")
    mpix = slides.size / 1e6
    return dict(mode=mode, tile=tile, overlap=overlap,
                tiles_per_forward=fwd.batches,
                launches=counts["attention_gate"],
                seconds=dt, mpix_per_s=mpix / dt, max_memory_gib=peak,
                probs_max_abs_err=perr, logits_max_abs_err=lerr,
                probs_max_abs_err_bf16_plain=perr_plain,
                logits_max_abs_err_bf16_plain=lerr_plain,
                logits_max_abs=scale)


def _halo_composition(seg, slide, tile, overlap, device) -> dict:
    """(n1): ``Segmenter.predict_tiled`` of one slide in halo mode, its
    gate calls recorded: each output tile against the model's direct
    forward of its reflect-padded window (the 16 windows in one batch, as
    the tiler runs them), in bf16, within TOL_BF16 of the logits' scale;
    every gate call against the plain version at its tile shapes."""
    import torch.nn.functional as F
    from segtpu_torch.infer.predict import nhwc_forward
    from segtpu_torch.infer.tiled import _halo
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    model = seg.state.model
    halo = _halo(tile, overlap)
    reset_launch_counts()
    with _GateCalls() as rec:
        probs = seg.predict_tiled(slide, tile=tile, overlap=overlap,
                                  mode="halo")
    launched = launch_counts()["attention_gate"]
    shapes, errs, shares = rec.against_plain(TOL_BF16)
    n = slide.shape[0] // tile
    check(len(rec.calls) == 4 and max(shares) <= 1.0
          and all(s[0] == n * n and s[1] == (tile + 2 * halo) >> (4 - i)
                  for i, s in enumerate(shapes)),
          f"tiled (n1) halo: the {len(rec.calls)} gate calls of one "
          f"slide's forward (want 4), (B, H, W, Cg, Cx, F) {shapes}, vs "
          f"the plain version: max_abs_err {errs}, {shares} of the "
          f"tolerance")
    del rec
    x = torch.from_numpy(slide[None, None]).to(device)
    padded = F.pad(x, (halo,) * 4, mode="reflect")[0].permute(1, 2, 0)
    wins = torch.stack([padded[oy:oy + tile + 2 * halo,
                               ox:ox + tile + 2 * halo]
                        for oy in range(0, slide.shape[0], tile)
                        for ox in range(0, slide.shape[1], tile)])
    with torch.inference_mode(), seg.engine.autocast():
        direct = torch.sigmoid(nhwc_forward(model, wins).float())
    direct = direct[:, halo:halo + tile, halo:halo + tile].cpu().numpy()
    got = probs.reshape(n, tile, n, tile, 1).transpose(0, 2, 1, 3, 4) \
        .reshape(n * n, tile, tile, 1)
    err = float(np.abs(got - direct).max())
    check(err <= TOL_BF16, f"tiled (n1) halo: each of the {n * n} output "
          f"tiles vs the model's direct bf16 forward of its padded window: "
          f"max_abs_err {err:.3g} (tol {TOL_BF16:.3g})")
    return dict(composition_max_abs_err=err, launches=launched,
                gate_path_shapes=shapes,
                gate_path_max_abs_err=errs, gate_path_tol_share=shares)


def _tta(seg, ref32, size, device) -> dict:
    """(n2): ``predict_proba(tta=True)`` on TTA_IMAGES images of size²:
    8 forwards and 32 gate launches, img/s (host clock, after a warm-up),
    held against the f32 TTA without kernels at §2's probability bar."""
    from segtpu_torch.infer.tta import tta_predict_proba
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(SEED + 9)
    x = rng.uniform(0, 1, (TTA_IMAGES, size, size)).astype(np.float32)
    seg.predict_proba(x, tta=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = seg.predict_proba(x, tta=True)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    want = tta_predict_proba(ref32, x[..., None], device=device)
    err = float(np.abs(got - want).max())
    check(got.shape == (TTA_IMAGES, size, size, 1)
          and counts["attention_gate"] == 32
          and counts["upsample2x_concat"] == 0,
          f"tta (n2): {TTA_IMAGES} images, {counts['attention_gate']} gate "
          f"launches (want 8 forwards x 4), shape {got.shape}")
    check(err <= TOL_PROBS, f"tta (n2): bf16 with kernels vs f32 TTA "
          f"without: max_abs_err {err:.3g} (tol {TOL_PROBS})")
    return dict(images=TTA_IMAGES, launches=counts["attention_gate"],
                img_per_s=TTA_IMAGES / dt, seconds=dt, probs_max_abs_err=err)


def _dir_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _export_and_serve(seg, ref32, slide, root, size, device) -> dict:
    """(n3): the flagship's artifact (symbolic batch, exported on the
    device), the same weights exported on the CPU, and the no-attention
    flagship's artifact, each served at its deployment site (a fresh
    process without ``segtpu_torch.models``); the checks of (n3)."""
    import os
    from segtpu_torch.infer.export import save_serving
    from segtpu_torch.infer.predict import predict_proba
    rng = np.random.default_rng(SEED + 10)
    xs = [rng.uniform(0, 1, (b, size, size)).astype(np.float32)
          for b in ARTIFACT_BATCHES]
    t0 = time.perf_counter()
    path = seg.export(os.path.join(root, "flagship"))
    export_s = time.perf_counter() - t0
    from segtpu_torch.models.unet import UNetWithBackbone
    cpu_model = UNetWithBackbone(backbone="resnet34", use_attention=True,
                                 device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               seg.state.model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_path = save_serving(os.path.join(root, "flagship-cpu"), cpu_model,
                            (size, size), compute_dtype=torch.bfloat16)
    export_cpu_s = time.perf_counter() - t0
    del cpu_model
    plain = _flagship_segmenter(False, device, size)
    path_na = plain.export(os.path.join(root, "no-attention"))
    meta_na = json.load(open(os.path.join(path_na, "meta.json")))

    for i, x in enumerate(xs):
        np.save(os.path.join(root, f"x{i}.npy"), x[..., None])
    job = {"device": device, "artifacts": {
        "flagship": {"path": path, "time": True,
                     "slide": os.path.join(root, "slide.npy")},
        "flagship-cpu": {"path": cpu_path},
        "no-attention": {"path": path_na}}}
    np.save(os.path.join(root, "slide.npy"), slide[None, ..., None])
    for name, spec in job["artifacts"].items():
        idx = range(len(xs)) if name == "flagship" else (1, 2)
        spec["inputs"] = [os.path.join(root, f"x{i}.npy") for i in idx]
        spec["outputs"] = [os.path.join(root, f"{name}-y{i}.npy")
                           for i in idx]
    with open(os.path.join(root, "job.json"), "w") as f:
        json.dump(job, f)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", _DEPLOYMENT_SITE,
                           os.path.join(root, "job.json")], cwd=here,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"serve (n3): the deployment site exited "
          f"{proc.returncode}")
    site = json.loads(proc.stdout.strip().splitlines()[-1]) \
        if proc.returncode == 0 else {"artifacts": {}}
    check(site.get("models_imported") == [], f"serve (n3): the deployment "
          f"site imported no segtpu_torch.models "
          f"({site.get('models_imported')})")

    res = dict(export_s=export_s, export_cpu_s=export_cpu_s,
               artifact_bytes=_dir_bytes(path),
               fused_upsample_levels=meta_na["fused_upsample_levels"])
    launches = {"attention_gate": 0, "upsample2x_concat": 0}
    models = {"flagship": seg, "flagship-cpu": seg, "no-attention": plain}
    for name, spec in job["artifacts"].items():
        got = site["artifacts"].get(name, {})
        calls = got.get("calls", [])
        live = models[name]
        per_call, errs = [], []
        for c, xpath, ypath in zip(calls, spec["inputs"], spec["outputs"]):
            x = np.load(xpath)
            y = np.load(ypath)
            want = live.predict_proba(x)
            errs.append(float(np.abs(y - want).max()))
            for k in launches:
                launches[k] += c["launches"][k]
            per_call.append(c["launches"])
        want_gate = 0 if name == "no-attention" else 4
        want_up = len(meta_na["fused_upsample_levels"]) \
            if name == "no-attention" else 0
        ok_launch = len(calls) == len(spec["inputs"]) and all(
            c["attention_gate"] == want_gate
            and c["upsample2x_concat"] == want_up for c in per_call)
        check(ok_launch, f"serve (n3) {name}: {len(calls)} calls at batches "
              f"{[c['batch'] for c in calls]}, launches per call "
              f"{per_call} (want {want_gate} gate, {want_up} upsample)")
        # the no-attention artifact's routing is frozen at batch 16: at
        # batch 5 it fuses where the live model does not, so that call is
        # held to §2's serving bar
        tols = [TOL_PROBS if (name == "no-attention" and c["batch"] != 16)
                else TOL_ARTIFACT for c in calls]
        check(bool(errs) and all(e <= t for e, t in zip(errs, tols)),
              f"serve (n3) {name}: vs the live bf16 predict_proba, "
              f"max_abs_err {errs} (tol {tols})")
        res[name] = dict(batches=[c["batch"] for c in calls],
                         launches_per_call=per_call, max_abs_err=errs,
                         **{k: got[k] for k in ("img_per_s", "tiled",
                                                "http_batch_equal",
                                                "http_slide_equal")
                            if k in got})
    flag = res["flagship"]
    tiled = flag.get("tiled", {"launches": {}})
    for k in launches:
        launches[k] += tiled["launches"].get(k, 0)
    check(flag.get("http_batch_equal") is True
          and flag.get("http_slide_equal") is True,
          f"serve (n3): make_server(tiled=True) answered a {size}² batch "
          f"and a {slide.shape[0]}² slide with the ServingModel's own "
          f"arrays, bit for bit ({flag.get('http_batch_equal')}, "
          f"{flag.get('http_slide_equal')})")
    check(tiled["launches"].get("attention_gate", 0) > 0
          and tiled["launches"]["attention_gate"] % 4 == 0,
          f"serve (n3): the artifact's tiled slide launched the gate "
          f"{tiled['launches'].get('attention_gate')} times (4 per forward)")
    # the bar must tell an f32 graph from a bf16 one: the f32 model's
    # probabilities against the live bf16 ones miss it
    f32err = float(np.abs(predict_proba(ref32, xs[-1], device=device)
                          - seg.predict_proba(xs[-1])).max())
    check(f32err > TOL_ARTIFACT, f"serve (n3): an f32 graph would miss the "
          f"artifact bar: f32 vs bf16 live max_abs_err {f32err:.3g} > "
          f"{TOL_ARTIFACT:.3g}")
    res.update(f32_vs_bf16_max_abs_err=f32err, launches=launches)
    return res


def phase_inference(device="cuda", size=SIZE, slide_size=SLIDE,
                    slides=SLIDES) -> dict:
    """(n1)-(n3) of the module docstring; prints the ``tiled``, ``tta``
    and ``serving_tiled`` lines and returns {"launches": ...}."""
    import tempfile
    seg = _flagship_segmenter(True, device, size)
    ref32 = copy.deepcopy(seg.state.model)
    _use_kernels(ref32, False)
    rng = np.random.default_rng(SEED + 8)
    imgs = rng.uniform(0, 1, (slides, slide_size, slide_size)).astype(
        np.float32)
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    modes = [_tiled_mode(seg, ref32, imgs, "halo", size, HALO_OVERLAP,
                         device),
             _tiled_mode(seg, ref32, imgs, "blend", size, BLEND_OVERLAP,
                         device)]
    # the Segmenter's own tiled entry point, halo mode at tile = size
    # (16 tiles of 544² per 2048² slide): one slide's composition, then
    # all slides timed
    comp = _halo_composition(seg, imgs[0], size, HALO_OVERLAP, device)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for im in imgs:
        seg.predict_tiled(im, tile=size, overlap=HALO_OVERLAP, mode="halo")
    seg_s = time.perf_counter() - t0
    seg_launches = launch_counts()["attention_gate"]
    check(seg_launches == 4 * slides, f"tiled (n1): Segmenter.predict_tiled "
          f"of {slides} slides launched the gate {seg_launches} times "
          f"(want 4 per slide: one forward of its tiles)")
    tiled = dict(slides=slides, slide=slide_size, modes=modes,
                 segmenter_halo_mpix_per_s=imgs.size / 1e6 / seg_s,
                 segmenter_launches=seg_launches, **comp)
    print("tiled " + json.dumps(tiled), flush=True)
    tta = _tta(seg, ref32, size, device)
    print("tta " + json.dumps(tta), flush=True)
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-serve-") as root:
        served = _export_and_serve(seg, ref32, imgs[0], root, size, device)
    print("serving_tiled " + json.dumps(served), flush=True)
    return {"launches": {
        "attention_gate": sum(m["launches"] for m in modes)
        + comp["launches"] + seg_launches + tta["launches"]
        + served["launches"]["attention_gate"],
        "upsample2x_concat": served["launches"]["upsample2x_concat"]}}


# ---------------------------------------------- (o) the fused training run

# (o1): the flagship of the training phase (resnet34, attention, 512²,
# bf16, B=8) through ``train_model`` with ``fused_run`` and stepwise, cuDNN
# deterministic: 20 training images (two full batches and a remainder of
# 4) and 4 validation images (one remainder batch). The plateau scheduler
# cuts unless the validation IoU grows elevenfold (patience 0, relative
# threshold 10); early stopping stops after epoch 2 of at most 3
# (min_delta 0.9, patience 1): every decision sits far from its
# threshold.
FUSED_TRAIN, FUSED_VAL = 20, 4
FUSED_CONFIG = dict(TRAIN_CONFIG, num_epochs=3, early_stopping_patience=1,
                    early_stopping_min_delta=0.9)
FUSED_PLATEAU = dict(patience=0, threshold=10.0)
# Fused against stepwise on the card: the same kernels on the same batches
# (cuDNN deterministic) and the same ``DeviceOptimizer.step()``, eager in
# one and replayed in the other, so the two runs should agree bit for bit;
# the bars are the ones a run that parts by rounding alone would still
# meet: per-epoch losses within 1e-4 of themselves (the JAX package's
# fused-run test holds its first epoch's losses within 2e-4 of its
# stepwise loop's), thresholded metrics within TOL_TRAIN_IOU, the two
# trained models' probabilities within §2's 0.05. (Updates that part by
# an ulp per step part this run by up to 9% of a bf16 loss in two epochs:
# no rounding-level bar holds two runs to each other unless their updates
# agree exactly.) The replays are also held, bit for bit, to the same
# runner's steps called eagerly.
TOL_FUSED_LOSS = 1e-4
# (o2): the no-attention flagship, 16 training and 12 validation images
# at B=8, 1 epoch: both validation batches (8 and the remainder of 4) pass
# ``fuse_min_work`` at level 2, so each replayed validation forward
# launches the upsample.
FUSED_UPSAMPLE_IMAGES = (16, 12)
# (o3): every optimizer under capture, resnet_tiny at 64², f32 (TF32 off),
# 10 training and 6 validation images at B=4, 3 epochs, each run from one
# model trained FUSED_PRETRAIN epochs stepwise beforehand (validation IoU
# above 1/11 from its first epoch on): with FUSED_PLATEAU the scheduler
# then cuts after epochs 2 and 3 whatever the IoU does (no IoU exceeds 11
# times one above 1/11), so epoch 3 trains at half the first LR.
FUSED_PRETRAIN = 6
FUSED_OPTIMIZERS = ("adam", "adamw", "sgd", "lamb")
FUSED_TINY = dict(backbone="resnet_tiny", use_attention=True,
                  img_size=(64, 64), batch_size=4, loss_fn="combo",
                  num_epochs=3, seed=SEED, verbose=False)


def _fused_fit(images, masks, n_train, config, fused, device,
               initial_state=None, plateau=FUSED_PLATEAU):
    """``train_model`` on the first ``n_train`` images, validated on the
    rest, with a plateau scheduler at ``plateau``; returns (result, host
    seconds, peak GiB, launch counts)."""
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.train.loop import train_model
    from segtpu_torch.train.optim import ReduceLROnPlateau
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_model(
        None, images[:n_train], masks[:n_train], images[n_train:],
        masks[n_train:], num_epochs=config["num_epochs"], device=device,
        config=dict(config, fused_run=fused),
        scheduler=ReduceLROnPlateau(config.get("learning_rate", 1e-3),
                                    **plateau),
        initial_state=initial_state)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30, launch_counts())


def _loss_err(a, b) -> float:
    """The largest relative difference of two runs' per-epoch training
    and validation losses."""
    return max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
               for key in ("train_metrics", "val_metrics")
               for x, y in zip(a[key], b[key]))


def _metric_err(a, b) -> float:
    return max(abs(x[k] - y[k]) for key in ("train_metrics", "val_metrics")
               for x, y in zip(a[key], b[key])
               for k in ("iou", "f1", "precision", "recall", "accuracy"))


def _same_decisions(a, b) -> bool:
    return (len(a["val_metrics"]) == len(b["val_metrics"])
            and a["lr_history"] == b["lr_history"]
            and a["best_epoch"] == b["best_epoch"])


def _bf16_probs(model, x) -> torch.Tensor:
    """The model's eager eval forward under bf16 autocast, probabilities."""
    model.eval()
    with torch.inference_mode(), torch.autocast("cuda",
                                                dtype=torch.bfloat16):
        return torch.sigmoid(model(x).float())


def _last_runner():
    from segtpu_torch.train import fused_run
    return fused_run.RUNNERS[fused_run.RUNNERS.keys()[-1]]


def _replay_ms(runner, x, y, steps: int) -> list:
    """CUDA-event ms of ``steps`` replays of the full training step on one
    resident batch, enqueued back to back, after one untimed replay (the
    ``train`` line's method, ``_step_ms``)."""
    runner.feed("train_full", x, y)
    runner.replay("train_full")
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    for start, end in spans:
        start.record()
        runner.replay("train_full")
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in spans]


def _kernel_events(fn) -> dict:
    """{kernel name: launches} of the device events ``torch.profiler``
    records over one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _sync_count(fn) -> int:
    """Synchronising CUDA operations in one call of ``fn``, as
    ``torch.cuda.set_sync_debug_mode`` reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _fused_flagship(device, backbone, size) -> dict:
    """(o1) and (o4)."""
    from segtpu_torch.data.preprocess import normalize_canonical
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.models.attention import invalidate_folds
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import TrainState, get_engine
    from segtpu_torch.train.loop import _materialize
    rng = np.random.default_rng(SEED + 11)
    imgs, masks = _blob_images(FUSED_TRAIN + FUSED_VAL, size, rng)
    config = dict(FUSED_CONFIG, img_size=(size, size), backbone=backbone,
                  use_attention=True)
    b = config["batch_size"]
    fused_run.RUNNERS.clear()
    fused, fused_s, fused_gib, fused_counts = _fused_fit(
        imgs, masks, FUSED_TRAIN, config, True, device)
    runner = _last_runner()
    warm = dict(runner.stats["warmup_calls"])
    capture_s = runner.stats["capture_s"]
    step, step_s, step_gib, step_counts = _fused_fit(
        imgs, masks, FUSED_TRAIN, config, False, device)
    epochs = len(fused["val_metrics"])
    val_forwards = -(-FUSED_VAL // b)
    loss_err, metric_err = _loss_err(fused, step), _metric_err(fused, step)
    check(_same_decisions(fused, step) and epochs == 2,
          f"fused (o1): epochs run {epochs} / {len(step['val_metrics'])} "
          f"(want 2), LR history {fused['lr_history']} / "
          f"{step['lr_history']}, best epoch {fused['best_epoch']} / "
          f"{step['best_epoch']}: fused / stepwise equal")
    check(loss_err <= TOL_FUSED_LOSS and metric_err <= TOL_TRAIN_IOU,
          f"fused (o1): per-epoch losses within {loss_err:.3g} of the "
          f"stepwise run's (tol {TOL_FUSED_LOSS}, relative), thresholded "
          f"metrics within {metric_err:.3g} (tol {TOL_TRAIN_IOU})")
    x = normalize_canonical(torch.from_numpy(imgs[FUSED_TRAIN:]).to(
        device)).contiguous(memory_format=torch.channels_last)
    prob_err = (_bf16_probs(fused["state"].model, x)
                - _bf16_probs(step["state"].model, x)).abs().max().item()
    check(prob_err <= TOL_PROBS,
          f"fused (o1): the two trained models' bf16 probabilities within "
          f"{prob_err:.3g} (tol {TOL_PROBS})")
    warm_val = warm.get("eval_full", 0) + warm.get("eval_rem", 0)
    gate_f, gate_s = fused_counts["attention_gate"], \
        step_counts["attention_gate"]
    check(gate_f == 4 * (epochs * val_forwards + warm_val)
          and gate_s == 4 * epochs * val_forwards,
          f"fused (o1): attention_gate launched {gate_f} times in the fused "
          f"run ({epochs} epochs × {val_forwards} replayed validation "
          f"forwards + {warm_val} warm-up calls, 4 each), {gate_s} stepwise")

    # (o4) and the cache: a second run of equal shapes from a model whose
    # gates hold cached folds replays without capturing
    engine = get_engine(config, device=device)
    model0 = engine.build_model().reset_parameters(
        torch.Generator().manual_seed(SEED))
    _bf16_probs(model0, x)                           # caches the folds
    hit, hit_s, hit_gib, hit_counts = _fused_fit(
        imgs, masks, FUSED_TRAIN, config, True, device,
        initial_state=TrainState(model0))
    hit_epochs = len(hit["val_metrics"])
    check(runner.stats["captures"] == 1 and runner.stats["runs"] == 2
          and len(fused_run.RUNNERS) == 1
          and hit_counts["attention_gate"] == 4 * hit_epochs * val_forwards,
          f"fused (o1): a second run of equal shapes: {runner.stats['runs']}"
          f" runs, {runner.stats['captures']} capture, "
          f"{len(fused_run.RUNNERS)} runner; attention_gate launched "
          f"{hit_counts['attention_gate']} times (4 per replayed validation "
          f"forward: {4 * hit_epochs * val_forwards})")
    refold = {}
    for name, model in (("fit", fused["state"].model), ("next_run", model0)):
        cached = _bf16_probs(model, x)
        invalidate_folds(model)
        fresh = _bf16_probs(model, x)
        refold[name] = (cached - fresh).abs().max().item()
    check(hit["state"].model is model0
          and max(refold.values()) <= TOL_BF16,
          f"fused (o4): eager bf16 probabilities of the models handed back "
          f"against the same models with every gate refolded: {refold} "
          f"(tol {TOL_BF16})")

    # host reads per epoch: the runner's count and set_sync_debug_mode's,
    # over ``run_training_fused`` on resident tensors
    ti, tm = _materialize(imgs[:FUSED_TRAIN], masks[:FUSED_TRAIN],
                          device=device)
    vi, vm = _materialize(imgs[FUSED_TRAIN:], masks[FUSED_TRAIN:],
                          device=device)

    def direct(num_epochs, state):
        return fused_run.run_training_fused(
            engine, state, ti, tm, vi, vm, batch_size=b,
            num_epochs=num_epochs, lr0=1e-3,
            generator=torch.Generator(device).manual_seed(SEED + 1),
            scheduler_params=dict(factor=0.5, min_lr=0.0, **FUSED_PLATEAU),
            es_patience=config["early_stopping_patience"],
            es_min_delta=config["early_stopping_min_delta"])

    new_state = lambda: engine.init_state(
        torch.Generator().manual_seed(SEED), 1e-3, 1e-5)
    reads0, box, state = runner.stats["host_reads"], {}, new_state()
    reset_launch_counts()
    syncs = _sync_count(lambda: box.update(out=direct(3, state)))
    reads = runner.stats["host_reads"] - reads0
    sync_epochs = box["out"]["epochs_ran"]
    check(syncs == reads == sync_epochs + 1 and runner.stats["captures"] == 1,
          f"fused (o1): {syncs} synchronising operations "
          f"(set_sync_debug_mode) in a run of {sync_epochs} epochs, the "
          f"runner's own count {reads}: one flag read per epoch and one "
          f"fetch at the end")

    # the replays against the same steps called eagerly, from the same state
    from segtpu_torch.data.loader import DeviceDataLoader
    eager_state = new_state()
    eager = fused_run.FusedRunner(engine, eager_state, FUSED_TRAIN, FUSED_VAL,
                                  graphs=False).run(
        eager_state, DeviceDataLoader(ti, tm, b),
        DeviceDataLoader(vi, vm, b, shuffle=False),
        torch.Generator(device).manual_seed(SEED + 1), 3, 1e-3,
        dict(factor=0.5, min_lr=0.0, **FUSED_PLATEAU),
        config["early_stopping_patience"],
        config["early_stopping_min_delta"])
    replayed = box["out"]
    same = all(replayed[k] == eager[k] for k in (
        "train_history", "val_history", "lr_history", "best_epoch"))
    w_r = replayed["final_state"].model.state_dict()
    w_e = eager["final_state"].model.state_dict()
    same_w = all(torch.equal(w_r[k], w_e[k]) for k in w_r)
    check(same and same_w,
          f"fused (o1): the replayed run against the same steps called "
          f"eagerly (graphs=False) from the same state: histories equal "
          f"{same}, final weights equal {same_w}")

    # a profiled replayed epoch names the gate kernel once per gate call
    state = new_state()
    events = _kernel_events(lambda: direct(1, state))
    gate_events = sum(n for k, n in events.items() if "gate_bf16_kernel" in k)
    direct_gate = launch_counts()["attention_gate"]
    check(gate_events == 4 * val_forwards,
          f"fused (o1): a profiled replayed epoch shows gate_bf16_kernel "
          f"{gate_events} times (4 per validation forward: "
          f"{4 * val_forwards})")

    # the step: replayed and stepwise on one resident batch
    xs = normalize_canonical(torch.from_numpy(imgs[:b]).to(device)).contiguous(
        memory_format=torch.channels_last)
    ys = torch.from_numpy(masks[:b]).to(device)[:, None].float()
    replay_ms = _replay_ms(runner, xs, ys, TIMED_STEPS)
    state = step["state"]
    stepwise_ms = _step_ms(engine, state, xs, ys, TIMED_STEPS)
    prof = {}
    for name, fn in (("replayed", lambda: runner.replay("train_full")),
                     ("stepwise", lambda: engine.train_step(state, xs, ys))):
        try:
            p = _profile_calls(fn, 3)
            prof[name] = {k: p[k] for k in ("profile_busy_share",
                                            "profile_busy_ms")}
        except Exception as exc:
            prof[name] = {"profile_error": repr(exc)}
    check(all("profile_busy_share" in p for p in prof.values()),
          f"fused (o1): profiled replayed and stepwise steps ({prof})")
    med = lambda v: statistics.median(v)
    quart = lambda v: statistics.quantiles(v, n=10)
    return dict(
        model="attention", backbone=backbone, size=size, batch=b,
        train_images=FUSED_TRAIN, val_images=FUSED_VAL, epochs=epochs,
        lr_history=fused["lr_history"], best_epoch=fused["best_epoch"],
        loss_rel_err=loss_err, metric_err=metric_err, probs_err=prob_err,
        refold_err=refold,
        step_ms={"replayed": med(replay_ms), "stepwise": med(stepwise_ms)},
        step_ms_p10_p90={"replayed": [quart(replay_ms)[0],
                                      quart(replay_ms)[-1]],
                         "stepwise": [quart(stepwise_ms)[0],
                                      quart(stepwise_ms)[-1]]},
        timed_steps=TIMED_STEPS, profile=prof, capture_s=capture_s,
        warmup_calls=warm,
        s_per_epoch={"fused_first": fused_s / epochs,
                     "fused_cached": hit_s / hit_epochs,
                     "stepwise": step_s / len(step["val_metrics"])},
        fit_s={"fused_first": fused_s, "fused_cached": hit_s,
               "stepwise": step_s},
        peak_gib={"fused_first": fused_gib, "fused_cached": hit_gib,
                  "stepwise": step_gib},
        host_syncs={"debug_mode": syncs, "runner": reads,
                    "epochs": sync_epochs},
        replays_equal_eager=same and same_w,
        gate_events_per_epoch=gate_events,
        launches={"attention_gate": gate_f + gate_s
                  + hit_counts["attention_gate"] + direct_gate})


def _fused_upsample(device, backbone, size) -> dict:
    """(o2): the upsample kernel from replayed validation forwards."""
    from segtpu_torch.train import fused_run
    n_train, n_val = FUSED_UPSAMPLE_IMAGES
    rng = np.random.default_rng(SEED + 12)
    imgs, masks = _blob_images(n_train + n_val, size, rng)
    config = dict(FUSED_CONFIG, img_size=(size, size), backbone=backbone,
                  use_attention=False, num_epochs=1)
    b = config["batch_size"]
    fused_run.RUNNERS.clear()
    fused, _, _, counts = _fused_fit(imgs, masks, n_train, config, True,
                                     device)
    runner = _last_runner()
    step, _, _, step_counts = _fused_fit(imgs, masks, n_train, config, False,
                                         device)
    warm = runner.stats["warmup_calls"]
    replays = runner.stats["replays"]
    model = fused["state"].model.eval()
    per = {kind: len(decoder_shapes(model, nb, size)[1])
           for kind, nb in (("eval_full", b), ("eval_rem", n_val % b))}
    want = sum(n * (replays.get(kind, 0) + warm.get(kind, 0))
               for kind, n in per.items())
    ups = counts["upsample2x_concat"]
    check(ups == want and min(per.values()) > 0,
          f"fused (o2): upsample2x_concat launched {ups} times from the "
          f"fused run's validation forwards; _fused_level predicts {want} "
          f"({per} per forward at B={b} / {n_val % b}, replays {replays}, "
          f"warm-up {warm})")
    loss_err, metric_err = _loss_err(fused, step), _metric_err(fused, step)
    check(_same_decisions(fused, step) and loss_err <= TOL_FUSED_LOSS
          and metric_err <= TOL_TRAIN_IOU,
          f"fused (o2): validation and training metrics of the fused run "
          f"against the stepwise run's: losses {loss_err:.3g} (tol "
          f"{TOL_FUSED_LOSS}, relative), thresholded {metric_err:.3g} (tol "
          f"{TOL_TRAIN_IOU})")
    return {"upsample": dict(per_forward=per, launches=ups, want=want,
                             loss_rel_err=loss_err, metric_err=metric_err),
            "upsample_launches": ups + step_counts["upsample2x_concat"]}


def _fused_optimizers(device) -> dict:
    """(o3): every optimizer's update under capture against stepwise."""
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import TrainState
    rng = np.random.default_rng(SEED + 13)
    imgs, masks = _blob_images(16, 64, rng)
    pre, _, _, c0 = _fused_fit(imgs, masks, 10,
                               dict(FUSED_TINY, num_epochs=FUSED_PRETRAIN),
                               False, device,
                               plateau=dict(patience=FUSED_PRETRAIN))
    lr0 = FUSED_TINY.get("learning_rate", 1e-3)
    res, gate = {}, c0["attention_gate"]
    for name in FUSED_OPTIMIZERS:
        fused_run.RUNNERS.clear()
        config = dict(FUSED_TINY, optimizer=name)
        fused, _, _, c1 = _fused_fit(
            imgs, masks, 10, config, True, device,
            initial_state=TrainState(copy.deepcopy(pre["state"].model)))
        step, _, _, c2 = _fused_fit(
            imgs, masks, 10, config, False, device,
            initial_state=TrainState(copy.deepcopy(pre["state"].model)))
        gate += c1["attention_gate"] + c2["attention_gate"]
        err = _loss_err(fused, step)
        check(_same_decisions(fused, step)
              and fused["lr_history"] == [lr0, lr0 / 2, lr0 / 4]
              and err <= TOL_FUSED_LOSS,
              f"fused (o3): {name} under capture: LR history "
              f"{fused['lr_history']} / {step['lr_history']} (want "
              f"{[lr0, lr0 / 2, lr0 / 4]}: epoch 3 at a cut LR), per-epoch "
              f"losses within {err:.3g} of stepwise (tol {TOL_FUSED_LOSS}, "
              f"relative)")
        res[name] = dict(loss_rel_err=err, lr_history=fused["lr_history"],
                         val_iou=[m["iou"] for m in fused["val_metrics"]])
    return {"optimizers": res, "optimizer_gate_launches": gate}


def _fused_cv(device, size=128) -> dict:
    """(o5): a 2-fold CV of the flagship with ``fused_run`` against the
    stepwise CV, on the data phase's TIFFs and (m1)'s configuration."""
    import tempfile
    from segtpu_torch.eval.cross_validation import CrossValidator
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.train import fused_run
    out, gate = {}, 0
    with tempfile.TemporaryDirectory(prefix="segtpu-torch-fused-cv-") as root:
        write_data_dir(root)
        cfg = dict(FOLD_CONFIG, data_dir=root, img_size=(size, size))
        fused_run.RUNNERS.clear()
        for fused in (True, False):
            v = CrossValidator(root, "W", n_splits=cfg["n_splits"],
                               random_state=cfg["random_state"],
                               augmentations_per_image=cfg[
                                   "augmentations_per_image"],
                               verbose=False, device=device)
            v._canonical(cfg["img_size"])       # decoded before the clock
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = v.cross_validate_single_model(None, dict(cfg,
                                                         fused_run=fused))
            torch.cuda.synchronize()
            out[fused] = (r["fold_results"], time.perf_counter() - t0)
            gate += launch_counts()["attention_gate"]
    runners = fused_run.RUNNERS.keys()
    stats = fused_run.RUNNERS[runners[-1]].stats if runners else {}
    err = max(abs(a[k] - b_[k]) for a, b_ in zip(out[True][0], out[False][0])
              for k in ("iou", "loss"))
    k = cfg["n_splits"]
    check(len(runners) == 1 and stats.get("runs") == k
          and stats.get("captures") == 1,
          f"fused (o5): {k} folds of equal size: {len(runners)} runner, "
          f"{stats.get('runs')} runs, {stats.get('captures')} capture")
    check(len(out[True][0]) == k and err <= TOL_FOLDS,
          f"fused (o5): each fold's final IoU and loss within {err:.3g} of "
          f"the stepwise CV's (tol {TOL_FOLDS})")
    return {"cv": dict(max_err=err, seconds={"fused": out[True][1],
                                             "stepwise": out[False][1]},
                       fold_iou={"fused": [f["iou"] for f in out[True][0]],
                                 "stepwise": [f["iou"]
                                              for f in out[False][0]]}),
            "cv_gate_launches": gate}


def phase_fused(device="cuda", backbone="resnet34", size=SIZE) -> dict:
    """(o1)-(o5) of the module docstring and the ``fused`` line."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        res = _fused_flagship(device, backbone, size)
        res.update(_fused_upsample(device, backbone, size))
        res.update(_fused_optimizers(device))
        res.update(_fused_cv(device))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    res["launches"] = {
        "attention_gate": res["launches"]["attention_gate"]
        + res.pop("optimizer_gate_launches") + res.pop("cv_gate_launches"),
        "upsample2x_concat": res.pop("upsample_launches")}
    res["cudnn_deterministic"] = True
    print("fused " + json.dumps(res), flush=True)
    return res


# ------------------------------------------------------- (p) multi-device
# One card, so the data-parallel path runs twice: NCCL with one rank in
# this process (p1), and gloo with two ranks, two processes on the card
# (p2, p4), since NCCL refuses two ranks on one device. Neither measures
# scaling.
MD_TRAIN_IMAGES, MD_VAL_IMAGES = 16, 4
# The world-1 wrapper's cost: this many CUDA-event spans of the DP step
# and of the plain step, alternated, on one resident batch.
MD_TIMED_STEPS = 30
# The world-2 DP step, bf16: this many spans.
MD_WORLD2_STEPS = 10
# (p2): the f32 DP step (TF32 off) against the one-process f32 step on the
# same 8 images. The two sum each BatchNorm's statistics in other orders
# (E[x²] − E[x]² over two ranks' sums against cuDNN's), f32 rounding of
# O(1) values over 2.6e5 pixels a channel at level 1: the loss within
# 1e-4 of itself and each running statistic within 1e-3 of its tensor's
# largest magnitude (the JAX package's dry run held 5e-3). Rank-local
# statistics miss the latter by the activations' own spread, 0.1-1.
TOL_MD_LOSS, TOL_MD_STATS = 1e-4, 1e-3
# (p2): the gradients the DP step summed over the ranks (what the
# optimizer took) against the one-process step's, within 1e-3 of the
# largest gradient. They hold the reduction to its factor, which the
# parameters after Adam's first step (lr·g/|g|) cannot: a mean in place of
# the sum halves them (an error of 0.5), and rank-local gradients (a
# plain step on half the rows) miss the bar too.
TOL_MD_GRADS = 1e-3
# (p2): bf16 probabilities of the row-sharded and tile-sharded predictors
# against the same forwards in one process: 2^-8 (half a bf16 ulp at 1;
# the forwards differ only in batch composition, so cuDNN may pick other
# algorithms).
TOL_MD_PROBS = 2.0 ** -8
MD_SLIDE, MD_HALO, MD_ACCUM = 2048, 32, 2
# The world-2 ranks' deadline; on expiry both are killed.
MD_TIMEOUT_S = 420
MD_FLAGSHIP = {"use_attention": True, "loss_fn": "combo",
               "dtype": "bfloat16"}


def _md_batch(n, size, seed, device):
    """n normalised flagship images (N, 1, S, S) channels_last and their
    masks on ``device``, from ``seed``."""
    from segtpu_torch.data.preprocess import normalize_canonical
    imgs, masks = _blob_images(n, size, np.random.default_rng(seed))
    x = normalize_canonical(torch.from_numpy(imgs).to(device)).contiguous(
        memory_format=torch.channels_last)
    return x, torch.from_numpy(masks).to(device)[:, None].float()


def _md_state_err(got: dict, want: dict) -> tuple:
    """(largest error of a parameter relative to the largest parameter,
    largest error of a running statistic relative to its tensor's largest
    magnitude)."""
    params = [k for k in want if want[k].is_floating_point()
              and "running" not in k]
    pmax = max(float(want[k].abs().max()) for k in params)
    perr = max(float((got[k] - want[k]).abs().max()) for k in params) / pmax
    serr = max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30)
               for k in want if "running" in k)
    return perr, serr


def _md_grads(model) -> dict:
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _md_grad_err(got: dict, want: dict) -> float:
    """Largest error of a gradient relative to the largest gradient."""
    gmax = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / gmax


def _md_world_one(tmp, device, backbone, size) -> dict:
    """(p1), then (r1) and (r1c) on its group: NCCL, one rank, this
    process."""
    from segtpu_torch.core.dist import create_mesh, init_process_group
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.parallel import DataParallel
    from segtpu_torch.train.engine import METRIC_KEYS, get_engine
    from segtpu_torch.train.optim import EarlyStopping, ReduceLROnPlateau
    backend = init_process_group(f"file://{tmp}/rdzv_world1", 1, 0,
                                 device=torch.device(device, 0))
    res = {"backend_world1": backend}
    try:
        dp = DataParallel(create_mesh(device=device))
        engine = get_engine(dict(MD_FLAGSHIP, backbone=backbone),
                            device=device)
        b = TRAIN_CONFIG["batch_size"]
        x, y = _md_batch(b, size, SEED + 20, device)
        outs = []
        for shard in (dp.shard, None):
            st = engine.init_state(torch.Generator().manual_seed(SEED), 1e-3,
                                   1e-5)
            if shard is not None:
                dp.replicate(st)
                st, m = engine.train_step(st, shard(x), shard(y))
            else:
                st, m = engine.train_step(st, x, y)
            outs.append((torch.stack(list(m.values())).cpu(),
                         {k: v.clone() for k, v in
                          st.model.state_dict().items()}))
        (ma, da), (mb, db) = outs
        same = torch.equal(ma, mb) and all(torch.equal(da[k], db[k])
                                           for k in da)
        check(same, f"multidevice (p1): a DP step over one rank ({backend}) "
              f"equals the plain step bit for bit: loss and metrics, "
              f"{len(da)} parameters and BatchNorm tensors")

        # two epochs over sharded loaders, both enqueued before one fetch,
        # with the plateau LR and early stopping (the dry run's stage 3)
        imgs, masks = _md_batch(MD_TRAIN_IMAGES + MD_VAL_IMAGES, size,
                                SEED + 21, device)
        n = MD_TRAIN_IMAGES
        tr = dp.shard_loader(DeviceDataLoader(imgs[:n], masks[:n], b))
        va = dp.shard_loader(DeviceDataLoader(imgs[n:], masks[n:], b,
                                              shuffle=False))
        st = dp.replicate(engine.init_state(
            torch.Generator().manual_seed(SEED + 1), 1e-3, 1e-5))
        sched = ReduceLROnPlateau(1e-3, mode="max", factor=0.5, patience=1)
        stop = EarlyStopping(patience=3, min_delta=0.0)
        gen = torch.Generator(device).manual_seed(SEED + 2)
        torch.cuda.synchronize()
        reset_launch_counts()
        window = []
        for _ in range(2):
            st, tt, vt = engine.run_train_and_eval_epoch_async(
                st, tr, va, sched.lr, gen)
            window.append(torch.stack([tt, vt]))
        fetched = torch.stack(window).cpu()
        counts = launch_counts()
        epochs = []
        for tv, vv in fetched:
            tm = dict(zip(METRIC_KEYS, (tv / tr.n).tolist()))
            vm = dict(zip(METRIC_KEYS, (vv / va.n).tolist()))
            sched.step(vm["iou"])
            stop.step(vm["iou"])
            epochs.append({"train_loss": tm["loss"], "val_loss": vm["loss"],
                           "val_iou": vm["iou"], "lr": sched.lr})
        val_forwards = 2 * -(-MD_VAL_IMAGES // b)
        check(all(np.isfinite([e["train_loss"], e["val_loss"]]).all()
                  for e in epochs)
              and counts["attention_gate"] == 4 * val_forwards,
              f"multidevice (p1): 2 pipelined epochs over sharded loaders "
              f"with plateau LR and early stopping: finite losses "
              f"({epochs}), attention_gate launched "
              f"{counts['attention_gate']} times in {val_forwards} "
              f"validation forwards (want 4 per forward)")
        res.update(epochs_world1=epochs, launches={
            "attention_gate": counts["attention_gate"],
            "upsample2x_concat": counts["upsample2x_concat"]})

        # the wrapper's own cost: DP and plain steps alternated, the DP
        # step placing its batch (``shard``) inside its span
        st = dp.replicate(engine.init_state(
            torch.Generator().manual_seed(SEED), 1e-3, 1e-5))
        runs = {"dp": lambda: engine.train_step(st, dp.shard(x), dp.shard(y)),
                "plain": lambda: engine.train_step(st, x, y)}
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        spans = {k: [] for k in runs}
        for _ in range(MD_TIMED_STEPS):
            for k, fn in runs.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                spans[k].append((start, end))
        torch.cuda.synchronize()
        for k, ev in spans.items():
            ms = [s.elapsed_time(e) for s, e in ev]
            q = statistics.quantiles(ms, n=10)
            res[f"step_ms_{k}_world1"] = statistics.median(ms)
            res[f"step_ms_{k}_world1_p10_p90"] = [q[0], q[-1]]
        res["dp_over_plain_world1"] = (res["step_ms_dp_world1"]
                                       / res["step_ms_plain_world1"])

        # the no-attention flagship's DP validation runs the upsample
        na = get_engine(dict(MD_FLAGSHIP, backbone=backbone,
                             use_attention=False), device=device)
        st = dp.replicate(na.init_state(
            torch.Generator().manual_seed(SEED), 1e-3, 1e-5))
        want = len(decoder_shapes(st.model.eval(), b, size)[1])
        val = dp.shard_loader(DeviceDataLoader(imgs[:b], masks[:b], b,
                                               shuffle=False))
        torch.cuda.synchronize()
        reset_launch_counts()
        vm = na.run_eval_epoch(st, val)
        ups = launch_counts()["upsample2x_concat"]
        check(ups == want and want > 0 and np.isfinite(vm["loss"]),
              f"multidevice (p1): the no-attention flagship's DP validation "
              f"forward (B={b}) launched upsample2x_concat {ups} times; "
              f"_fused_level predicts {want}")
        res["launches"]["upsample2x_concat"] += ups

        # (r1), (r1c) on this group
        res["fused_dp_world1"] = _fdp_world_one(dp, device, backbone, size)
    finally:
        torch.distributed.destroy_process_group()
    return res


def _md_rank(rank: int, tmp: str, device: str, size: int, slide: int
             ) -> int:
    """(p2), (p4), (q2) and (r2) on rank ``rank`` of 2: gloo, both ranks
    on ``device`` (cuda:0), flagship images of ``size``², a ``slide``²
    slide.
    Writes its results and checks to ``<tmp>/md_<rank>.json``."""
    from segtpu_torch.core import hlo_profile
    from segtpu_torch.core.dist import (all_gather_rows, create_mesh,
                                        init_process_group)
    from segtpu_torch.infer.predict import nhwc_forward
    from segtpu_torch.infer.tiled import make_tiled_predictor
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.parallel import DataParallel, spatial_predict
    from segtpu_torch.train.engine import get_engine
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    init_process_group(f"file://{tmp}/rdzv_world2", 2, rank, device=device,
                       backend="gloo")
    device = torch.device(device).type
    res, checks = {"rank": rank}, []

    def record(ok, what):
        checks.append([bool(ok), what])

    try:
        mesh = create_mesh(device=device)
        dp = DataParallel(mesh)
        group = mesh.get_group(0)
        b = TRAIN_CONFIG["batch_size"]
        x, y = _md_batch(b, size, SEED + 30, device)

        # f32 flagship step at global B=8 (4 rows a rank), and A=2
        # accumulated micro-batches of 8
        e32 = get_engine({"backbone": "resnet34", "use_attention": True,
                          "loss_fn": "combo"}, device=device)
        xa, ya = _md_batch(MD_ACCUM * b, size, SEED + 31, device)
        xa, ya = (t.reshape(MD_ACCUM, b, *t.shape[1:]) for t in (xa, ya))
        fresh = lambda: e32.init_state(torch.Generator().manual_seed(SEED),
                                       1e-3, 1e-5)
        got = {}
        for kind, step, args in (
                ("step", e32.train_step, (dp.shard(x), dp.shard(y))),
                ("accum", e32.train_step_accum,
                 (dp.shard(xa, dim=1), dp.shard(ya, dim=1)))):
            st = dp.replicate(fresh())
            st, m = step(st, *args)
            sd = st.model.state_dict()
            got[kind] = (float(m["loss"]), sd, _md_grads(st.model))
            record(all(t.is_cuda for t in sd.values()) and all(
                p.grad.is_cuda for p in st.model.parameters()),
                f"(p2) f32 DP {kind}: every parameter, gradient and "
                f"statistic on cuda")
            # both ranks hold the same state: their checksums gathered
            sums = torch.stack([v.double().sum() for v in sd.values()
                                if v.is_floating_point()])[None]
            both = all_gather_rows(sums, 2, group)
            record(torch.equal(both[0], both[1]),
                   f"(p2) f32 DP {kind}: both ranks hold the same "
                   f"{sums.shape[1]} tensors after the update")
        if rank == 0:
            refs = {}
            for kind, step, args in (("step", e32.train_step, (x, y)),
                                     ("accum", e32.train_step_accum,
                                      (xa, ya))):
                st, m = step(fresh(), *args)
                refs[kind] = (float(m["loss"]), st.model.state_dict(),
                              _md_grads(st.model))
            for kind in ("step", "accum"):
                (lg, sg, gg), (lr_, sr, gr) = got[kind], refs[kind]
                loss_err = abs(lg - lr_) / abs(lr_)
                perr, serr = _md_state_err(sg, sr)
                gerr = _md_grad_err(gg, gr)
                mean_err = _md_grad_err({k: g / 2 for k, g in gg.items()},
                                        gr)
                record(loss_err <= TOL_MD_LOSS and serr <= TOL_MD_STATS
                       and gerr <= TOL_MD_GRADS < mean_err,
                       f"(p2) f32 DP {kind} at global B={b} on 2 ranks vs "
                       f"the one-process step: loss {loss_err:.3g} (tol "
                       f"{TOL_MD_LOSS}), running statistics {serr:.3g} of "
                       f"their scale (tol {TOL_MD_STATS}), summed gradients "
                       f"{gerr:.3g} of the largest (tol {TOL_MD_GRADS}; "
                       f"their mean over the ranks {mean_err:.3g}); "
                       f"parameters {perr:.3g} of the largest")
                res[f"f32_{kind}"] = dict(
                    loss_rel_err=loss_err, stats_err=serr, grad_err=gerr,
                    grad_err_mean_reduction=mean_err, param_err=perr)
            # what rank-local statistics and gradients give: a plain step
            # on rank 0's 4 rows against the global step
            st, m = e32.train_step(fresh(), x[:b // 2], y[:b // 2])
            perr, serr = _md_state_err(st.model.state_dict(),
                                       refs["step"][1])
            gerr = _md_grad_err(_md_grads(st.model), refs["step"][2])
            res["rank_local"] = dict(
                loss_rel_err=abs(float(m["loss"]) - refs["step"][0])
                / abs(refs["step"][0]), stats_err=serr, grad_err=gerr,
                param_err=perr)
            record(serr > TOL_MD_STATS and gerr > TOL_MD_GRADS,
                   f"(p2) rank-local statistics and gradients (a plain step "
                   f"on 4 of the 8 rows) miss the bars: running statistics "
                   f"{serr:.3g} of their scale, gradients {gerr:.3g} of the "
                   f"largest, loss {res['rank_local']['loss_rel_err']:.3g}")
            del refs, st
        del got, x, y, xa, ya
        torch.cuda.empty_cache()

        # bf16 DP step time at world 2 and one profiled step (p4)
        eng = get_engine(dict(MD_FLAGSHIP, backbone="resnet34"),
                         device=device)
        x, y = _md_batch(b, size, SEED + 20, device)
        st = dp.replicate(eng.init_state(torch.Generator().manual_seed(SEED),
                                         1e-3, 1e-5))
        step = lambda: eng.train_step(st, dp.shard(x), dp.shard(y))
        step()
        torch.cuda.synchronize()
        ms = []
        for _ in range(MD_WORLD2_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        res["step_ms_dp_world2"] = statistics.median(ms)
        res["step_ms_dp_world2_all"] = ms
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step()
            torch.cuda.synchronize()
        summary = hlo_profile.collective_summary(prof, world=2)
        coll = hlo_profile.extract_collectives(prof, world=2)
        ar = sorted(c["payload_bytes"] for c in coll
                    if c["opcode"] == "all-reduce")
        params = sum(p.numel() * p.element_size()
                     for p in st.model.parameters())
        bns = [m for m in st.model.modules()
               if type(m).__name__ == "BatchNorm2d"]
        bn_bytes = 2 * 2 * 4 * sum(m.num_features for m in bns)
        record(ar and ar[-1] == params and len(ar) == 1 + 2 * len(bns)
               and sum(ar[:-1]) == bn_bytes,
               f"(p4) profiled DP step: the gradient all-reduce carries "
               f"{ar[-1] if ar else None} bytes = the {params} bytes of the "
               f"parameters; {len(ar) - 1} BatchNorm syncs (want "
               f"{2 * len(bns)}, {len(bns)} BatchNorms forward and "
               f"backward) of {sum(ar[:-1])} bytes (want {bn_bytes})")
        res["collectives"] = summary
        res["param_bytes"] = params
        res["batchnorms"] = len(bns)
        res["bn_sync_bytes"] = sum(ar[:-1])
        res["profile"] = hlo_profile.profile_trace(prof)
        del st, eng
        torch.cuda.empty_cache()

        # the bf16 flagship (f32 parameters, autocast) row-sharded over
        # the 2 ranks, and its tile batches sharded over them
        model = _randomized_flagship(True, device, size=size)
        dp.replicate(model)
        slide = np.random.default_rng(SEED + 32).uniform(
            0, 1, (slide, slide)).astype(np.float32)
        auto = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with auto():
            probs = spatial_predict(model, None, slide, mesh, halo=MD_HALO)
        torch.cuda.synchronize()
        res["spatial_ms"] = (time.perf_counter() - t0) * 1e3
        gate = launch_counts()["attention_gate"]
        launches = gate
        record(gate == 4, f"(p2) spatial_predict: {gate} gate launches on "
               f"this rank's band forward (want 4)")
        if rank == 0:
            # the two haloed bands (edge rows replicated at the image's
            # edges) forwarded in this one process
            img = torch.from_numpy(slide).to(device)[..., None]
            hb, h = slide.shape[0] // 2, MD_HALO
            top, bot = img[:1].expand(h, -1, -1), img[-1:].expand(h, -1, -1)
            bands = [torch.cat([top, img[:hb + h]]),
                     torch.cat([img[hb - h:], bot])]
            with torch.inference_mode(), auto():
                ref = torch.cat([torch.sigmoid(nhwc_forward(
                    model, band[None])[0, h:h + hb].float())
                    for band in bands]).cpu().numpy()
            err = float(np.abs(probs - ref).max())
            record(probs.shape == (*slide.shape, 1)
                   and err <= TOL_MD_PROBS,
                   f"(p2) spatial_predict of a {slide.shape[0]}² slide over 2 "
                   f"bands (halo {h}, band forward {hb + 2 * h}×"
                   f"{slide.shape[1]}) vs the "
                   f"same two bands in one process: probs max_abs_err "
                   f"{err:.3g} (tol {TOL_MD_PROBS})")
            res["spatial_err"] = err
        img = torch.from_numpy(slide).to(device)[..., None]
        fwd = lambda t: nhwc_forward(model, t)
        for mode, tile, overlap in (("halo", size, 32), ("blend", size, 64)):
            sharded = make_tiled_predictor(fwd, tile=tile, overlap=overlap,
                                           mode=mode, shard_tiles_axis="data")
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            with torch.inference_mode(), auto(), mesh:
                got = torch.sigmoid(sharded(img).float())
            torch.cuda.synchronize()
            res[f"tiled_{mode}_ms"] = (time.perf_counter() - t0) * 1e3
            gate = launch_counts()["attention_gate"]
            launches += gate
            with torch.inference_mode(), auto():
                want = torch.sigmoid(make_tiled_predictor(
                    fwd, tile=tile, overlap=overlap, mode=mode)(img).float())
            err = float((got - want).abs().max())
            record(gate == 4 and err <= TOL_MD_PROBS,
                   f"(p2) {mode} tiles of the slide sharded over 2 ranks vs "
                   f"unsharded: probs max_abs_err {err:.3g} (tol "
                   f"{TOL_MD_PROBS}); {gate} gate launches on this rank's "
                   f"tile batch (want 4)")
            res[f"tiled_{mode}_err"] = err
        res["gate_launches"] = launches
        del model
        torch.cuda.empty_cache()
        res["bands"] = _md_bands(rank, device, size, record)
        torch.cuda.empty_cache()
        res["fused_dp"] = _fdp_rank(mesh, device, size, record)
    finally:
        res["checks"] = checks
        with open(f"{tmp}/md_{rank}.json", "w") as f:
            json.dump(res, f)
        torch.distributed.destroy_process_group()
    return 0


# (q2): the flagship on a (data 1 × spatial 2) mesh, bands of SIZE/2 rows.
# The f32 SGD step's update (parameters after it minus before) against
# the one-process step's, within 1e-3 of the largest update. SGD's update
# is lr·(g + wd·p), so this holds the summed gradients as (p2) does
# (TOL_MD_GRADS); at LR_BANDS = 1 the update outweighs the parameters, so
# their f32 rounding (half an ulp of |p| ≤ 1.1, 6e-8) stays far below the
# bar, which at lr 1e-3 it would not. Bands each padded with zeros in
# place of their neighbours' rows (each band its own image) must miss it.
# The loss and the running statistics as (p2)'s.
TOL_BANDS_UPDATE, LR_BANDS = 1e-3, 1.0
# (q2): the f32 validation forward on the bands against one process, in
# probabilities. The two differ only in the order of sums (3.6e-7 on an
# H100), so 1e-5 holds the rows at the band cuts, where a fault in the
# eval path (band-local pooling, a missing halo) shows; the zero-padded
# control's forward must miss it. bf16 is reported only: its rounding
# alone reaches 2^-8.
TOL_BANDS_PROBS = 1e-5


def _zero_padded(self, x, kernel, stride, padding, dilation=1, fill=0.0):
    """Negative control for ``Bands.pad_rows``: the layer's own padding
    at both cuts of the band, no rows from the neighbours."""
    bottom = max(0, dilation * (kernel - 1) + 1 - stride - padding)
    edge = lambda k: x.new_full((*x.shape[:2], k, x.shape[3]), fill)
    return torch.cat([edge(padding), x, edge(bottom)], dim=2)


def _update_err(got: dict, want: dict, init: dict) -> float:
    """Largest error of a step's parameter update relative to the largest
    update of ``want``."""
    keys = [k for k in want if want[k].is_floating_point()
            and "running" not in k]
    dmax = max(float((want[k] - init[k]).abs().max()) for k in keys)
    return max(float((got[k] - want[k]).abs().max()) for k in keys) / dmax


def _md_bands(rank: int, device: str, size: int, record) -> dict:
    """(q2) on rank ``rank`` of 2: the flagship (resnet34, attention) on a
    (data 1 × spatial 2) mesh, each rank a band of ``size // 2`` rows of
    B=8 images: the f32 SGD step against one process (rank 0) and its
    zero-padded control, the bf16 step's time, one profiled step's
    collectives, the engine's eval step and a validation forward on the
    bands (4 gate launches each) against one process."""
    from unittest import mock
    from segtpu_torch.core import hlo_profile
    from segtpu_torch.core.dist import create_mesh
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.parallel import DataParallel
    from segtpu_torch.parallel.data_parallel import local_batch, synced
    from segtpu_torch.parallel.spatial import Bands
    from segtpu_torch.train.engine import get_engine
    mesh = create_mesh(axis_sizes=(1, 2), axis_names=("data", "spatial"),
                       device=device)
    dp = DataParallel(mesh)
    place = lambda t: dp.shard(t, spatial_axis="spatial")
    b = TRAIN_CONFIG["batch_size"]
    x, y = _md_batch(b, size, SEED + 50, device)
    xb, yb = place(x), place(y)
    res = {"band": list(xb.to_local().shape)}
    record(tuple(xb.to_local().shape) == (b, 1, size // 2, size)
           and xb.to_local().is_cuda,
           f"(q2) this rank's band of the batch: "
           f"{tuple(xb.to_local().shape)} on cuda")

    e32 = get_engine({"backbone": "resnet34", "use_attention": True,
                      "loss_fn": "combo", "optimizer": "sgd"}, device=device)
    fresh = lambda: e32.init_state(torch.Generator().manual_seed(SEED),
                                   LR_BANDS, 1e-5)
    init = {k: v.clone() for k, v in fresh().model.state_dict().items()}

    def stepped(xx, yy):
        st, m = e32.train_step(fresh(), xx, yy)
        return float(m["loss"]), st.model.state_dict()

    got = {"bands": stepped(xb, yb)}
    with mock.patch.object(Bands, "pad_rows", _zero_padded):
        got["zero_padded"] = stepped(xb, yb)
    if rank == 0:
        lr_, sr = stepped(x, y)
        for name, (lg, sg) in got.items():
            loss_err = abs(lg - lr_) / abs(lr_)
            _, serr = _md_state_err(sg, sr)
            uerr = _update_err(sg, sr, init)
            res[f"f32_{name}"] = dict(loss_rel_err=loss_err,
                                      stats_err=serr, update_err=uerr)
        ok, zp = res["f32_bands"], res["f32_zero_padded"]
        record(ok["loss_rel_err"] <= TOL_MD_LOSS
               and ok["stats_err"] <= TOL_MD_STATS
               and ok["update_err"] <= TOL_BANDS_UPDATE
               < zp["update_err"],
               f"(q2) f32 SGD step (lr {LR_BANDS}) on 2 bands of "
               f"{size // 2}×{size} (B={b}) vs the one-process step: loss "
               f"{ok['loss_rel_err']:.3g} "
               f"(tol {TOL_MD_LOSS}), running statistics "
               f"{ok['stats_err']:.3g} of their scale (tol {TOL_MD_STATS}), "
               f"update {ok['update_err']:.3g} of the largest (tol "
               f"{TOL_BANDS_UPDATE}); zero-padded bands: update "
               f"{zp['update_err']:.3g}, statistics {zp['stats_err']:.3g}, "
               f"loss {zp['loss_rel_err']:.3g}")
    del got, init
    torch.cuda.empty_cache()

    # the bf16 step's time and one profiled step's collectives
    eng = get_engine(dict(MD_FLAGSHIP, backbone="resnet34"), device=device)
    st = eng.init_state(torch.Generator().manual_seed(SEED), 1e-3, 1e-5)
    step = lambda: eng.train_step(st, xb, yb)
    step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(MD_WORLD2_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    res["step_ms"] = statistics.median(ms)
    res["step_ms_all"] = ms
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    coll = hlo_profile.extract_collectives(prof, world=2)
    by = {}
    for c in coll:
        n, nb = by.get(c["opcode"], (0, 0))
        by[c["opcode"]] = (n + 1, nb + c["payload_bytes"])
    params = sum(p.numel() * p.element_size() for p in st.model.parameters())
    ar = max((c["payload_bytes"] for c in coll
              if c["opcode"] == "all-reduce"), default=None)
    record(by.get("send", (0,))[0] > 0
           and by.get("send", (0,))[0] == by.get("recv", (0,))[0]
           and by.get("all-gather", (0,))[0] == 2 and ar == params,
           f"(q2) profiled step on the bands: halo rows by point-to-point "
           f"sends and receives ({by.get('send')}, {by.get('recv')}: count, "
           f"bytes), 2 all-gathers (logits and masks; "
           f"{by.get('all-gather')}), the gradient all-reduce of the "
           f"{params} parameter bytes ({ar})")
    res["collectives"] = {k: {"count": n, "payload_bytes": nb}
                          for k, (n, nb) in by.items()}
    res["profile"] = hlo_profile.profile_trace(prof)

    # the engine's (bf16) eval step on the bands, and validation forwards
    # on the bands in f32 (held) and bf16 (reported) against one process
    model = st.model
    torch.cuda.synchronize()
    reset_launch_counts()
    vec = eng._eval_step_vec(st, xb, yb)
    gates = [launch_counts()["attention_gate"]]
    xl, _, sync = local_batch(xb, yb)
    probs = {}
    for name, auto in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        reset_launch_counts()
        with torch.inference_mode(), torch.autocast(
                "cuda", dtype=torch.bfloat16, enabled=auto != torch.float32), \
                synced(model, sync):
            probs[name] = sync.gather(torch.sigmoid(model.eval()(xl).float()))
        gates.append(launch_counts()["attention_gate"])
    res["gate_launches"] = sum(gates)
    record(gates == [4, 4, 4] and bool(torch.isfinite(vec).all()),
           f"(q2) the engine's eval step (bf16) and validation forwards in "
           f"f32 and bf16 on this rank's band: {gates} gate launches (want "
           f"4 each), finite metrics")
    with mock.patch.object(Bands, "pad_rows", _zero_padded), \
            torch.inference_mode(), synced(model, sync):
        probs["f32_zero_padded"] = sync.gather(
            torch.sigmoid(model.eval()(xl).float()))
    if rank == 0:
        want = {}
        for name, auto in (("f32", torch.float32),
                           ("bf16", torch.bfloat16)):
            with torch.inference_mode(), torch.autocast(
                    "cuda", dtype=torch.bfloat16,
                    enabled=auto != torch.float32):
                want[name] = torch.sigmoid(model(x).float())
        want["f32_zero_padded"] = want["f32"]
        for name, p in probs.items():
            res[f"probs_err_{name}"] = float((p - want[name]).abs().max())
        err, zp = res["probs_err_f32"], res["probs_err_f32_zero_padded"]
        record(probs["f32"].shape == want["f32"].shape
               and err <= TOL_BANDS_PROBS < zp,
               f"(q2) f32 validation forward on 2 bands vs one process: "
               f"probs max_abs_err {err:.3g} (tol {TOL_BANDS_PROBS}); "
               f"zero-padded bands {zp:.3g}; bf16 "
               f"{res['probs_err_bf16']:.3g}")
    return res


def _md_world_two(tmp: str, device, size: int, slide: int) -> dict:
    """(p2), (p4): two ranks of this script on the card (gloo); each must
    exit 0; their checks are made here."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS="4")
    dev = "cuda:0" if str(device) == "cuda" else str(device)
    logs = [open(f"{tmp}/md_{r}.log", "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, __file__, "--md-rank",
                               str(r), tmp, dev, str(size), str(slide)],
                              stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env)
             for r in (0, 1)]
    deadline = time.monotonic() + MD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    res = {}
    for r, p in enumerate(procs):
        ok = p.returncode == 0
        tail = open(f"{tmp}/md_{r}.log").read()[-3000:]
        check(ok, f"multidevice (p2): rank {r} of 2 (gloo, cuda:0) exited "
              f"{p.returncode}" + ("" if ok else f":\n{tail}"))
        try:
            with open(f"{tmp}/md_{r}.json") as f:
                res[r] = json.load(f)
        except (OSError, ValueError):
            check(False, f"multidevice (p2): rank {r} left no results")
            continue
        for ok, what in res[r].pop("checks"):
            check(ok, f"multidevice rank {r} {what}")
    return res


def _md_fold_placement(device, size=32) -> dict:
    """(p3): 2 folds streamed with each fold placed on ``cuda:0`` by
    ``devices`` against the default placement (the dry run's stage 6)."""
    from segtpu_torch.eval.fold_parallel import train_folds_parallel
    rng = np.random.default_rng(SEED + 40)
    folds = []
    for _ in range(2):
        fi = torch.from_numpy(rng.uniform(0, 1, (4, 1, size, size))
                              .astype(np.float32)).to(device)
        vi = torch.from_numpy(rng.uniform(0, 1, (2, 1, size, size))
                              .astype(np.float32)).to(device)
        folds.append((fi, (fi > 0.5).float(), vi, (vi > 0.5).float()))
    cfg = {"backbone": "resnet_tiny", "use_attention": False,
           "loss_fn": "combo", "img_size": (size, size), "batch_size": 2,
           "num_epochs": 2, "seed": 3}
    placed = train_folds_parallel(folds, cfg,
                                  devices=[torch.device(device, 0)] * 2,
                                  device=device)
    plain = train_folds_parallel(folds, cfg, device=device)
    hist = lambda r: [[m["loss"], m["iou"]] for m in r["val_metrics"]]
    same = all(hist(a) == hist(b) for a, b in zip(placed, plain))
    check(same and all(np.isfinite(hist(a)).all() for a in placed),
          f"multidevice (p3): 2 folds placed by devices=['cuda:0', 'cuda:0'] "
          f"equal the default placement ({[hist(a) for a in placed]})")
    return {"folds_placed_equal": same}


# ------------------------------------ (r) the data-parallel fused run
# (r1): (o1)'s flagship run (20 training images at B=8, 4 validation
# images, 3 epochs, the plateau scheduler and early stopping) through
# ``run_training_fused`` on (p1)'s NCCL mesh of one rank, against the same
# run in one process: at world 1 the data-parallel step is the plain step
# op for op (p1), so the two runs, cuDNN deterministic, agree bit for bit.
# The replayed steps of both runners and the stepwise DP step alternated,
# this many CUDA-event spans each.
FDP_TIMED_STEPS = 30
# (r2): on (p2)'s two gloo ranks, f32 (TF32 off), 12 training images at
# B=8 (a full batch of 4 + 4 rows and a remainder of 2 + 2) and 4
# validation images, (o1)'s scheduler and early stopping (2 epochs run):
# the eager DP runner (``graphs=False``; gloo cannot be captured) against
# the stepwise DP epochs, by (p2)'s bars: decisions equal, per-epoch
# losses within TOL_MD_LOSS of themselves, the final parameters within
# TOL_MD_GRADS of the largest.
FDP_W2_TRAIN, FDP_W2_VAL = 12, 4


def _fdp_data(n_train, n_val, size, seed, device):
    from segtpu_torch.train.loop import _materialize
    imgs, masks = _blob_images(n_train + n_val, size,
                               np.random.default_rng(seed))
    return (*_materialize(imgs[:n_train], masks[:n_train], device=device),
            *_materialize(imgs[n_train:], masks[n_train:], device=device))


def _fdp_run(engine, data, config, device, **kw):
    """``run_training_fused`` from seed ``SEED``'s weights with (o1)'s
    schedule; (result, host s, (peak GiB, GiB allocated before it: the
    runners already cached hold their graphs' pools), launch counts)."""
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.train.fused_run import run_training_fused
    state = engine.init_state(torch.Generator().manual_seed(SEED), 1e-3,
                              1e-5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_training_fused(
        engine, state, *data, batch_size=config["batch_size"],
        num_epochs=config["num_epochs"], lr0=1e-3,
        generator=torch.Generator(device).manual_seed(SEED + 1),
        scheduler_params=dict(factor=0.5, min_lr=0.0, **FUSED_PLATEAU),
        es_patience=config["early_stopping_patience"],
        es_min_delta=config["early_stopping_min_delta"], **kw)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() / 2 ** 30, resident),
            launch_counts())


def _same_run(a, b) -> bool:
    """Histories, decisions and the final and returned weights equal bit
    for bit."""
    same = all(a[k] == b[k] for k in (
        "train_history", "val_history", "lr_history", "best_epoch",
        "epochs_ran", "best_found"))
    for key in ("state", "final_state"):
        da, db = (r[key].model.state_dict() for r in (a, b))
        same = same and all(torch.equal(da[k], db[k]) for k in da)
    return same


def _alternated_ms(fns: dict, turns: int) -> dict:
    """{name: (median, p10, p90)} of CUDA-event spans of each call, the
    calls alternated turn by turn, after one untimed call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    spans = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans[k].append((start, end))
    torch.cuda.synchronize()
    out = {}
    for k, ev in spans.items():
        ms = [a.elapsed_time(b) for a, b in ev]
        q = statistics.quantiles(ms, n=10)
        out[k] = (statistics.median(ms), q[0], q[-1])
    return out


def _fdp_collectives(engine, group, device) -> dict:
    """(r1c): the port's collective helpers captured in one CUDA graph on
    the NCCL group of one rank: ``all_reduce_`` on a flat buffer of the
    flagship's gradients, ``all_reduce_sum`` on its BatchNorms' per-channel
    sums, ``broadcast_`` and ``all_gather_rows`` on a logits batch;
    replayed twice on new inputs against the eager calls, bit for bit.
    At world 1 every reduction is the identity: ``all_reduce_``,
    ``all_reduce_sum`` and ``broadcast_`` leave their inputs as they were,
    so an empty graph would pass their comparison too, and only
    ``all_gather_rows``'s output (a tensor of the graph's own) shows that
    a collective was captured and replayed. (r1k) captures them in whole
    training steps; neither shows that they sum across cards (NCCL
    refuses two ranks on one card; A25)."""
    from segtpu_torch.core.dist import (all_gather_rows, all_reduce_,
                                        all_reduce_sum, broadcast_)
    from segtpu_torch.train.fused_run import WARMUP_CALLS
    model = engine.build_model()
    grad_n = sum(p.numel() for p in model.parameters())
    bn_n = 2 * sum(m.num_features for m in model.modules()
                   if type(m).__name__ == "BatchNorm2d")
    b = TRAIN_CONFIG["batch_size"]
    shapes = [(grad_n,), (bn_n,), (grad_n,), (b, 1, SIZE, SIZE)]
    del model
    gen = torch.Generator(device).manual_seed(SEED + 50)
    fresh = lambda: [torch.randn(sh, generator=gen, device=device)
                     for sh in shapes]

    def calls(a, s, c, d):
        return (all_reduce_(a, group), all_reduce_sum(s, group),
                broadcast_(c, 0, group), all_gather_rows(d, b, group))

    static = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            calls(*static)
    torch.cuda.current_stream().wait_stream(side)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls(*static)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    equal = []
    for _ in range(2):
        new = fresh()
        for t, v in zip(static, new):
            t.copy_(v)
        graph.replay()
        want = calls(*[v.clone() for v in new])
        torch.cuda.synchronize()
        equal.append(all(torch.equal(g, w) for g, w in zip(outs, want)))
    events = _kernel_events(graph.replay)
    nccl = {k: n for k, n in events.items() if "nccl" in k.lower()}
    ms = _alternated_ms({"replayed": graph.replay,
                         "eager": lambda: calls(*static)}, 10)
    check(all(equal),
          f"fused_dp (r1c): all_reduce_ of {4 * grad_n} bytes of gradients, "
          f"all_reduce_sum of {bn_n} BatchNorm sums, broadcast_ and "
          f"all_gather_rows of a B={b} logits batch captured in one CUDA "
          f"graph on NCCL (world 1) and replayed twice on new inputs: equal "
          f"to the eager calls bit for bit {equal} (at world 1 the in-place "
          f"reductions cannot be told apart from the identity; the gather's "
          f"output can)")
    return dict(grad_bytes=4 * grad_n, bn_sums=bn_n, replays_equal=equal,
                capture_s=capture_s, nccl_kernels_per_replay=nccl,
                ms={k: v[0] for k, v in ms.items()})


@contextlib.contextmanager
def one_rank_sync(group, calls: dict):
    """Within it, a batch sharded over a mesh of one rank keeps a
    ``StepSync`` over ``group``: ``local_batch`` drops one-rank groups, so
    that the world-1 data-parallel step is the plain step and issues no
    collective. The engine's steps then sum the BatchNorms' statistics,
    gather the logits and masks and all-reduce the gradients laid end to
    end, each over the one rank, as a step of a larger world does.
    ``calls`` counts the ``torch.distributed`` collectives they call."""
    from unittest import mock
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from segtpu_torch.parallel.data_parallel import StepSync
    from segtpu_torch.train import engine as engine_module
    local_batch = engine_module.local_batch

    def kept(images, masks):
        x, y, sync = local_batch(images, masks)
        if sync is None and isinstance(images, DTensor):
            sync = StepSync(group, images.shape[images.ndim - 4])
        return x, y, sync

    def counted(name):
        fn = getattr(dist, name)

        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    with mock.patch.object(engine_module, "local_batch", kept), \
            mock.patch.object(dist, "all_reduce", counted("all_reduce")), \
            mock.patch.object(dist, "all_gather", counted("all_gather")):
        yield


def _fdp_kept_sync(dp, engine, data, config, device, one) -> tuple:
    """(r1k): (r1)'s DP run with the one-rank group kept in every step
    (``one_rank_sync``), so that the runner's graphs capture the
    BatchNorms' all-reduces, the logits' and masks' gathers and the
    all-reduce of the gradients' 97,764,916 bytes on NCCL. The captured
    run against the same runner's steps called eagerly, bit for bit; a
    second run replays with no collective called from Python; the first
    run's peak memory (the graphs' pool holds the flat gradient buffer).
    At world 1 each sum is the identity and each gather a copy: this
    shows the steps' collectives captured and replayed, not the sums
    (A25). (runner, results, launch counts)."""
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.train import fused_run
    group, b = dp.mesh.get_group(0), config["batch_size"]
    # a runner of its own: its key cannot tell the kept group's steps
    # from the plain ones
    fused_run.RUNNERS.clear()
    first_calls, again_calls, eager_calls = {}, {}, {}
    with one_rank_sync(group, first_calls):
        cap, cap_s, cap_gib, counts = _fdp_run(engine, data, config, device,
                                               mesh=dp.mesh)
    runner = _last_runner()
    with one_rank_sync(group, again_calls):
        again, _, _, again_counts = _fdp_run(engine, data, config, device,
                                             mesh=dp.mesh)
    ti, tm, vi, vm = data
    state = engine.init_state(torch.Generator().manual_seed(SEED), 1e-3,
                              1e-5)
    eager_runner = fused_run.FusedRunner(
        engine, state, ti.shape[0], vi.shape[0], graphs=False,
        placement=fused_run.Placement(dp.mesh))
    reset_launch_counts()
    with one_rank_sync(group, eager_calls):
        eager = eager_runner.run(
            state, DeviceDataLoader(ti, tm, b, shuffle=True),
            DeviceDataLoader(vi, vm, b, shuffle=False),
            torch.Generator(device).manual_seed(SEED + 1),
            config["num_epochs"], 1e-3,
            dict(factor=0.5, min_lr=0.0, **FUSED_PLATEAU),
            config["early_stopping_patience"],
            config["early_stopping_min_delta"])
    torch.cuda.synchronize()
    eager_counts = launch_counts()
    same_eager = _same_run(cap, eager)
    same_again = _same_run(again, cap)
    check(runner.placement is not None and runner.stats["captures"] == 1
          and runner.stats["runs"] == 2
          and first_calls.get("all_reduce", 0) > 0
          and first_calls.get("all_gather", 0) > 0 and not again_calls
          and same_again and same_eager,
          f"fused_dp (r1k): the DP fused run with its one-rank group kept in "
          f"every step: collectives called while it warmed up and captured "
          f"{first_calls}, by the eager runner {eager_calls}, by its second "
          f"run (replays only) {again_calls or 'none'}; {runner.stats['captures']} "
          f"capture in {runner.stats['runs']} runs; the second run equal "
          f"{same_again}; the captured run equal to the same steps called "
          f"eagerly bit for bit: {same_eager}")
    perr, serr = _md_state_err(cap["final_state"].model.state_dict(),
                               one["final_state"].model.state_dict())
    loss_err = max(abs(a["loss"] - w["loss"]) / abs(w["loss"])
                   for key in ("train_history", "val_history")
                   for a, w in zip(cap[key], one[key]))
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in runner.model.parameters())
    res = dict(
        calls_first_run=first_calls, calls_eager_run=eager_calls,
        calls_second_run=again_calls, equal_to_eager=same_eager,
        capture_s=runner.stats["capture_s"], fit_s_first=cap_s,
        peak_gib_first=cap_gib[0], resident_gib_before=cap_gib[1],
        flat_gradient_bytes=grad_bytes,
        # information, not a check: the global-batch BatchNorm's formula
        # (E[x²] − E[x]²) parts from cuDNN's by rounding, and bf16 runs
        # that part by an ulp part by far more within two epochs
        against_one_process=dict(
            decisions_equal=all(cap[k] == one[k] for k in (
                "epochs_ran", "lr_history", "best_epoch")),
            loss_rel_err=loss_err, param_err=perr, stat_err=serr))
    launches = {k: counts[k] + again_counts[k] + eager_counts[k]
                for k in ("attention_gate", "upsample2x_concat")}
    return runner, res, launches


def _fdp_world_one(dp, device, backbone, size) -> dict:
    """(r1) and (r1c): NCCL, one rank, this process."""
    from segtpu_torch.data.preprocess import normalize_canonical
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import get_engine
    config = dict(FUSED_CONFIG, img_size=(size, size), backbone=backbone,
                  use_attention=True)
    engine = get_engine(config, device=device)
    b = config["batch_size"]
    data = _fdp_data(FUSED_TRAIN, FUSED_VAL, size, SEED + 11, device)
    fused_run.RUNNERS.clear()
    one, one_s, one_gib, one_counts = _fdp_run(engine, data, config, device)
    one_runner = _last_runner()
    dp_out, dp_s, dp_gib, counts = _fdp_run(engine, data, config, device,
                                            mesh=dp.mesh)
    keys = fused_run.RUNNERS.keys()
    runner = fused_run.RUNNERS[keys[-1]]
    warm = dict(runner.stats["warmup_calls"])
    epochs = dp_out["epochs_ran"]
    val_forwards = -(-FUSED_VAL // b)
    warm_val = warm.get("eval_full", 0) + warm.get("eval_rem", 0)
    gate = counts["attention_gate"]
    check(len(keys) == 2 and keys[0] != keys[1]
          and runner.placement is not None and runner is not one_runner
          and runner.stats["captures"] == 1
          and gate == 4 * (epochs * val_forwards + warm_val),
          f"fused_dp (r1): run_training_fused on an NCCL mesh of one rank "
          f"captured its own graphs ({len(keys)} runners, keyed apart; "
          f"{runner.stats['captures']} capture); attention_gate launched "
          f"{gate} times ({epochs} epochs × {val_forwards} replayed "
          f"validation forwards + {warm_val} warm-up calls, 4 each)")
    same = _same_run(dp_out, one)
    check(same and epochs == 2,
          f"fused_dp (r1): the DP fused run (world 1) against the one-process "
          f"fused run, cuDNN deterministic: histories, LR history "
          f"{dp_out['lr_history']}, best epoch {dp_out['best_epoch']}, "
          f"{epochs} epochs run (want 2), final and returned weights equal "
          f"bit for bit: {same}")
    again, again_s, _, again_counts = _fdp_run(engine, data, config, device,
                                               mesh=dp.mesh)
    check(runner.stats["captures"] == 1 and runner.stats["runs"] == 2
          and len(fused_run.RUNNERS) == 2 and _same_run(again, dp_out)
          and again_counts["attention_gate"]
          == 4 * again["epochs_ran"] * val_forwards,
          f"fused_dp (r1): a second DP run of equal shapes: "
          f"{runner.stats['runs']} runs, {runner.stats['captures']} capture, "
          f"the same results, attention_gate launched "
          f"{again_counts['attention_gate']} times (4 per replayed "
          f"validation forward)")
    kept_runner, kept, kept_launches = _fdp_kept_sync(dp, engine, data,
                                                      config, device, one)

    # the step: the runners' replays and the stepwise DP step alternated
    imgs, masks = _blob_images(b, size, np.random.default_rng(SEED + 20))
    x = normalize_canonical(torch.from_numpy(imgs).to(device)).contiguous(
        memory_format=torch.channels_last)
    y = torch.from_numpy(masks).to(device)[:, None].float()
    for r in (runner, one_runner, kept_runner):
        r.feed("train_full", x, y)
    st = dp.replicate(engine.init_state(
        torch.Generator().manual_seed(SEED), 1e-3, 1e-5))
    ms = _alternated_ms({
        "replayed_dp": lambda: runner.replay("train_full"),
        "replayed_one_process": lambda: one_runner.replay("train_full"),
        "replayed_dp_kept_sync": lambda: kept_runner.replay("train_full"),
        "stepwise_dp": lambda: engine.train_step(st, dp.shard(x),
                                                 dp.shard(y))},
        FDP_TIMED_STEPS)
    del st
    # where the kept group's step spends its time: its replays and the
    # plain DP runner's under the profiler, the five costliest kernels
    kept["profile"] = {
        name: _profile_calls(lambda r=r: r.replay("train_full"), 3)
        for name, r in (("kept_sync", kept_runner), ("dp", runner))}

    # the no-attention flagship: its replayed validation forwards launch
    # the upsample as ``_fused_level`` predicts
    n_train, n_val = FUSED_UPSAMPLE_IMAGES
    na_config = dict(config, use_attention=False, num_epochs=1)
    na = get_engine(na_config, device=device)
    na_out, _, _, na_counts = _fdp_run(
        na, _fdp_data(n_train, n_val, size, SEED + 12, device), na_config,
        device, mesh=dp.mesh)
    na_runner = _last_runner()
    nw, nr = na_runner.stats["warmup_calls"], na_runner.stats["replays"]
    model = na_out["state"].model.eval()
    per = {kind: len(decoder_shapes(model, nb, size)[1])
           for kind, nb in (("eval_full", b), ("eval_rem", n_val % b))}
    want = sum(n * (nr.get(kind, 0) + nw.get(kind, 0))
               for kind, n in per.items())
    ups = na_counts["upsample2x_concat"]
    check(ups == want and min(per.values()) > 0
          and na_runner.placement is not None,
          f"fused_dp (r1): the no-attention flagship's DP fused run launched "
          f"upsample2x_concat {ups} times from its replayed validation "
          f"forwards; _fused_level predicts {want} ({per} per forward, "
          f"replays {nr}, warm-up {nw})")

    res = dict(
        backbone=backbone, size=size, batch=b, train_images=FUSED_TRAIN,
        val_images=FUSED_VAL, epochs=epochs, lr_history=dp_out["lr_history"],
        best_epoch=dp_out["best_epoch"], equal_to_one_process=same,
        step_ms_world1={k: v[0] for k, v in ms.items()},
        step_ms_world1_p10_p90={k: [v[1], v[2]] for k, v in ms.items()},
        dp_replay_over_one_process=ms["replayed_dp"][0]
        / ms["replayed_one_process"][0],
        timed_steps=FDP_TIMED_STEPS, capture_s=runner.stats["capture_s"],
        capture_s_one_process=one_runner.stats["capture_s"],
        peak_gib={"dp_first": dp_gib[0], "one_process_first": one_gib[0]},
        resident_gib_before={"dp_first": dp_gib[1],
                             "one_process_first": one_gib[1]},
        fit_s={"dp_first": dp_s, "dp_cached": again_s,
               "one_process_first": one_s},
        warmup_calls=warm, upsample=dict(per_forward=per, launches=ups,
                                         want=want),
        kept_sync=kept,
        launches={"attention_gate": one_counts["attention_gate"] + gate
                  + again_counts["attention_gate"]
                  + kept_launches["attention_gate"],
                  "upsample2x_concat": ups
                  + kept_launches["upsample2x_concat"]})
    res["collectives"] = _fdp_collectives(engine, dp.mesh.get_group(0),
                                          device)
    fused_run.RUNNERS.clear()
    return res


def _stepwise_dp(engine, state, tr, va, gen, num_epochs, lr0, sched,
                 es_patience, es_min_delta) -> dict:
    """The stepwise loop's epochs (``train_model``'s scheduler, early
    stopping and best epoch) over sharded loaders."""
    from segtpu_torch.train.optim import EarlyStopping, ReduceLROnPlateau
    plateau = ReduceLROnPlateau(lr0, mode="max", **sched)
    stop = EarlyStopping(patience=es_patience, min_delta=es_min_delta)
    out = {"train_history": [], "val_history": [], "lr_history": []}
    lr, best_iou, best_epoch = lr0, 0.0, 0
    for e in range(num_epochs):
        state, tm, vm = engine.run_train_and_eval_epoch(state, tr, va, lr,
                                                        gen)
        out["train_history"].append(tm)
        out["val_history"].append(vm)
        lr = plateau.step(vm["iou"])
        out["lr_history"].append(lr)
        if vm["iou"] > best_iou:
            best_iou, best_epoch = vm["iou"], e
        if stop.step(vm["iou"]):
            break
    out.update(best_epoch=best_epoch, epochs_ran=len(out["val_history"]),
               state=state)
    return out


def _fdp_rank(mesh, device, size, record) -> dict:
    """(r2) on this rank of 2 (gloo, both ranks on the card)."""
    import hashlib
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.parallel import shard_loader
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import get_engine
    config = dict(FUSED_CONFIG, img_size=(size, size), backbone="resnet34",
                  use_attention=True, dtype="float32")
    engine = get_engine(config, device=device)
    b = config["batch_size"]
    ti, tm, vi, vm = _fdp_data(FDP_W2_TRAIN, FDP_W2_VAL, size, SEED + 60,
                               device)
    res = {}
    fused_run.RUNNERS.clear()
    try:
        _fdp_run(engine, (ti, tm, vi, vm), config, device, mesh=mesh)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    record(refused is not None and "cannot capture" in refused
           and len(fused_run.RUNNERS) == 0,
           f"(r2) run_training_fused on the gloo mesh of 2 ranks with CUDA "
           f"tensors refuses to capture: {refused!r}; "
           f"{len(fused_run.RUNNERS)} runners cached")

    sched = dict(factor=0.5, min_lr=0.0, **FUSED_PLATEAU)
    args = (config["num_epochs"], 1e-3, sched,
            config["early_stopping_patience"],
            config["early_stopping_min_delta"])
    fresh = lambda: engine.init_state(torch.Generator().manual_seed(SEED),
                                      1e-3, 1e-5)
    state = fresh()
    runner = fused_run.FusedRunner(engine, state, FDP_W2_TRAIN, FDP_W2_VAL,
                                   graphs=False,
                                   placement=fused_run.Placement(mesh))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eager = runner.run(state, DeviceDataLoader(ti, tm, b),
                       DeviceDataLoader(vi, vm, b, shuffle=False),
                       torch.Generator(device).manual_seed(SEED + 1), *args)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    gate = launch_counts()["attention_gate"]
    step = _stepwise_dp(
        engine, fresh(), shard_loader(DeviceDataLoader(ti, tm, b), mesh),
        shard_loader(DeviceDataLoader(vi, vm, b, shuffle=False), mesh),
        torch.Generator(device).manual_seed(SEED + 1), *args)
    gate_all = launch_counts()["attention_gate"]
    epochs = eager["epochs_ran"]
    val_forwards = -(-FDP_W2_VAL // b)
    decisions = all(eager[k] == step[k] for k in ("epochs_ran", "lr_history",
                                                  "best_epoch"))
    loss_err = max(abs(a["loss"] - w["loss"]) / abs(w["loss"])
                   for key in ("train_history", "val_history")
                   for a, w in zip(eager[key], step[key]))
    perr, _ = _md_state_err(eager["final_state"].model.state_dict(),
                            step["state"].model.state_dict())
    record(decisions and loss_err <= TOL_MD_LOSS and perr <= TOL_MD_GRADS,
           f"(r2) the eager DP fused runner (f32, gloo, world 2) against the "
           f"stepwise DP epochs: {epochs} epochs, LR history "
           f"{eager['lr_history']} / {step['lr_history']}, best epoch "
           f"{eager['best_epoch']} / {step['best_epoch']} equal {decisions}; "
           f"losses within {loss_err:.3g} of themselves (tol {TOL_MD_LOSS}), "
           f"final parameters within {perr:.3g} of the largest (tol "
           f"{TOL_MD_GRADS})")
    record(gate == 4 * epochs * val_forwards,
           f"(r2) the eager DP runner launched attention_gate {gate} times on "
           f"this rank ({epochs} epochs × {val_forwards} validation forwards, "
           f"want 4 each)")
    sd = eager["final_state"].model.state_dict()
    digest = hashlib.sha1(b"".join(
        v.detach().contiguous().cpu().numpy().tobytes()
        for v in sd.values())).hexdigest()
    res.update(
        eager_s=eager_s, eager_s_per_epoch=eager_s / epochs, epochs=epochs,
        loss_rel_err=loss_err, param_err=perr,
        histories={k: eager[k] for k in ("train_history", "val_history",
                                         "lr_history", "best_epoch")},
        weights_sha1=digest, gate_launches=gate_all)
    return res


def phase_multidevice(device="cuda", backbone="resnet34", size=SIZE,
                      slide=MD_SLIDE) -> dict:
    """(p1)-(p4) of the module docstring and the ``multidevice`` line."""
    import tempfile
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        # the rendezvous files and the ranks' logs and results; the checks
        # print a failed rank's log tail
        with tempfile.TemporaryDirectory(prefix="chip_smoke_md_") as tmp:
            res = _md_world_one(tmp, device, backbone, size)
            ranks = _md_world_two(tmp, device, size, slide)
        res.update(_md_fold_placement(device))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    r0 = ranks.get(0, {})
    res.update({k: r0.get(k) for k in (
        "step_ms_dp_world2", "step_ms_dp_world2_all", "spatial_ms",
        "tiled_halo_ms", "tiled_blend_ms", "spatial_err", "tiled_halo_err",
        "tiled_blend_err", "f32_step", "f32_accum", "rank_local",
        "collectives", "param_bytes", "batchnorms", "bn_sync_bytes",
        "profile")})
    world2 = sum(r.get("gate_launches", 0) for r in ranks.values())
    res["launches"]["attention_gate"] += world2
    res["gate_launches_world2"] = world2
    print("multidevice " + json.dumps(res), flush=True)
    bands = {r: ranks[r].get("bands", {}) for r in ranks}
    res["spatial_train"] = dict(bands.get(0, {}), gate_launches_per_rank=[
        bands[r].get("gate_launches") for r in sorted(bands)])
    res["launches"]["attention_gate"] += sum(
        v.get("gate_launches", 0) for v in bands.values())
    print("spatial_train " + json.dumps(res["spatial_train"]), flush=True)

    # (r): world 1 from this process, world 2 from the ranks
    fdp = res.pop("fused_dp_world1")
    w2 = {r: ranks[r].get("fused_dp", {}) for r in sorted(ranks)}
    hist = [w2[r].get("histories") for r in w2]
    sha = [w2[r].get("weights_sha1") for r in w2]
    check(len(w2) == 2 and hist[0] is not None and hist[0] == hist[1]
          and sha[0] == sha[1],
          f"fused_dp (r2): both ranks' histories and final weights equal bit "
          f"for bit (weights sha1 {sha})")
    r0 = w2.get(0, {})
    fdp["world2"] = {k: r0.get(k) for k in (
        "eager_s", "eager_s_per_epoch", "epochs", "loss_rel_err",
        "param_err")}
    fdp["world2"]["gate_launches_per_rank"] = [
        w2[r].get("gate_launches") for r in w2]
    for k, n in fdp["launches"].items():
        res["launches"][k] += n
    res["launches"]["attention_gate"] += sum(
        w2[r].get("gate_launches", 0) for r in w2)
    fdp["launches"]["attention_gate"] += sum(
        w2[r].get("gate_launches", 0) for r in w2)
    res["fused_dp"] = fdp
    print("fused_dp " + json.dumps(fdp), flush=True)
    return res


# ------------------------------------------- (q1) the s2d stem, reparam_in_train
# The stem alone, each form timed by CUDA events around single calls after
# an L2 flush, the forms alternated call by call over this many turns.
STEM_TURNS = 20


def _stem_s2d_cin8(stem, x):
    """The s2d stem with its phases zero-padded to 8 channels (the JAX
    package's form, its TPU's best), for the stem's timing only."""
    import torch.nn.functional as F
    from segtpu_torch.models.backbones import stem_s2d_weight
    xs = F.pixel_unshuffle(x, 2).contiguous(memory_format=torch.channels_last)
    xs = torch.cat([xs, torch.zeros_like(xs)], dim=1)
    w4 = stem_s2d_weight(stem.weight)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)),
                    torch.cat([w4, torch.zeros_like(w4)], dim=1))


def phase_reparam(device="cuda", batch=BATCH, size=SIZE) -> dict:
    """(q1): the flagship's stem alone in its three forms (plain 7×7/s2,
    s2d over 4 phase channels, s2d padded to 8) and the B=16 serving
    forward (gate kernel on) with the s2d stem and the plain one,
    alternated; the forward with the s2d stem held to the f32 model
    without kernels and with the plain stem (§2's bars), 4 gate launches;
    one f32 ``reparam_in_train`` step of resnet_tiny against the CPU's
    float64 step (train (a)'s bars). A ``reparam {...}`` line."""
    from segtpu_torch.kernels import launch_counts, reset_launch_counts
    from segtpu_torch.models.unet import UNetWithBackbone
    ref32 = _randomized_flagship(True, device, size=size)
    model = copy.deepcopy(ref32).to(torch.bfloat16)
    stem = model.input_conv
    x = torch.rand(batch, 1, size, size, device=device,
                   generator=torch.Generator(device).manual_seed(SEED + 60),
                   dtype=torch.bfloat16).contiguous(
                       memory_format=torch.channels_last)

    def form(s2d):
        def call():
            stem.s2d = s2d
            return stem(x)
        return call
    forms = {"plain": form(False), "s2d": form(True),
             "s2d_cin8": lambda: _stem_s2d_cin8(stem, x)}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    spans = {k: [] for k in forms}
    with torch.inference_mode():
        ref = forms["plain"]().float()
        errs = {k: float((f().float() - ref).abs().max())
                for k, f in forms.items()}
        for f in forms.values():
            f()
        torch.cuda.synchronize()
        for _ in range(STEM_TURNS):
            for k, f in forms.items():
                flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                f()
                end.record()
                spans[k].append((start, end))
        torch.cuda.synchronize()
    stem.s2d = True
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in spans.items()}
    stem_ms = {k: statistics.median(v) for k, v in ms.items()}
    scale = float(ref.abs().max())
    check(max(errs.values()) <= TOL_BF16 * scale,
          f"(q1) the stem's s2d forms vs its plain form, bf16 at B={batch} "
          f"{size}²: max_abs_err {errs} (tol {TOL_BF16 * scale:.3g})")

    fwd_s2d, fwd_plain, fwd_s2d_all, fwd_plain_all = _forward_ms(
        model, x, lambda m, on: setattr(m, "stem_s2d", on))
    rng = np.random.default_rng(SEED + 61)
    images = rng.uniform(0, 1, (batch, size, size)).astype(np.float32)
    _use_kernels(ref32, False)
    ref32.stem_s2d = False
    lg_ref = _logits(ref32, images, device)
    lscale = float(lg_ref.abs().max())
    # the bf16 model with the plain stem: bf16's own error
    model.stem_s2d = False
    lg = _logits(model, images, device)
    lerr_plain = float((lg - lg_ref).abs().max())
    perr_plain = float((torch.sigmoid(lg) - torch.sigmoid(lg_ref)).abs()
                       .max())
    model.stem_s2d = True
    torch.cuda.synchronize()
    reset_launch_counts()
    lg = _logits(model, images, device)
    gates = launch_counts()["attention_gate"]
    lerr = float((lg - lg_ref).abs().max())
    perr = float((torch.sigmoid(lg) - torch.sigmoid(lg_ref)).abs().max())
    tol_p = max(TOL_PROBS, TOL_KERNEL_OVER_BF16 * perr_plain)
    tol_l = max(TOL_LOGITS_REL * lscale, TOL_KERNEL_OVER_BF16 * lerr_plain)
    check(gates == 4 and perr <= tol_p and lerr <= tol_l,
          f"(q1) bf16 flagship forward with the s2d stem and the gate "
          f"kernel ({gates} launches, want 4) vs the f32 model without "
          f"kernels and with the plain stem: probs {perr:.3g} (tol "
          f"{tol_p:.3g}), logits {lerr:.3g} (tol {tol_l:.3g}); the bf16 "
          f"model with the plain stem: {perr_plain:.3g}, {lerr_plain:.3g}")
    # the form a freshly built model's stem takes
    default = UNetWithBackbone(backbone="resnet_tiny", device="cpu").stem_s2d
    check(default == (stem_ms["s2d"] < stem_ms["plain"]),
          f"(q1) the stem's default form (stem_s2d={default}) is the one "
          f"that is faster alone: s2d {stem_ms['s2d']:.4f} ms, plain "
          f"{stem_ms['plain']:.4f} ms (medians of {STEM_TURNS}), s2d "
          f"padded to 8 channels {stem_ms['s2d_cin8']:.4f} ms")
    res = dict(batch=batch, size=size, stem_ms=stem_ms, stem_ms_all=ms,
               stem_max_abs_err=errs, forward_ms_s2d=fwd_s2d,
               forward_ms_plain=fwd_plain, forward_ms_s2d_turns=fwd_s2d_all,
               forward_ms_plain_turns=fwd_plain_all,
               stem_s2d_default=default,
               s2d_faster_alone=stem_ms["s2d"] < stem_ms["plain"],
               probs_max_abs_err=perr, logits_max_abs_err=lerr,
               probs_max_abs_err_plain_stem=perr_plain,
               logits_max_abs_err_plain_stem=lerr_plain,
               gate_launches=gates)
    res.update(_step_check(device, label="(q1) reparam_in_train",
                           reparam_in_train=True))
    print("reparam " + json.dumps(res), flush=True)
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
    encoders = phase_encoders()
    phase_pretrained()
    grid = phase_grid()
    folds = phase_folds()
    selection = phase_selection()
    inference = phase_inference()
    fused = phase_fused()
    multi = phase_multidevice()
    reparam = phase_reparam()
    # each kernel's launches on its own main paths: the serving models
    # and the training runs that run it, or the bench entry points for the
    # conv and the pair
    launches = {"attention_gate": served["attention_gate"]["launches"]
                + trained["launches"]["attention_gate"]
                + loaded["launches"]["attention_gate"]
                + encoders["launches"]["attention_gate"]
                + grid["launches"]["attention_gate"]
                + folds["launches"]["attention_gate"]
                + selection["launches"]["attention_gate"]
                + inference["launches"]["attention_gate"]
                + fused["launches"]["attention_gate"]
                + multi["launches"]["attention_gate"]
                + reparam["gate_launches"],
                "upsample2x_concat": served["upsample2x_concat"]["launches"]
                + trained["upsample_launches_no_attention"]
                + encoders["launches"]["upsample2x_concat"]
                + grid["launches"]["upsample2x_concat"]
                + folds["launches"]["upsample2x_concat"]
                + selection["launches"]["upsample2x_concat"]
                + inference["launches"]["upsample2x_concat"]
                + fused["launches"]["upsample2x_concat"]
                + multi["launches"]["upsample2x_concat"],
                "conv3x3_bn_relu": benched["conv3x3_bn_relu"],
                "conv_pair_bn_relu": benched["conv_pair_bn_relu"]}

    # per kernel: the sums over its flagship shapes (bf16); the gate's and
    # the upsample's sums over the other encoders' shapes apart, under
    # ``encoders``
    kernels = []
    for name, recs in records.items():
        recs = [r for r in recs if r["serving"]]
        total = lambda key: sum(r[key] for r in recs)
        lib = [r["library_ms"] for r in recs]
        entry = dict(
            name=name, route="cuda", **KERNEL_META[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=max(recs, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=None if None in lib else sum(lib))
        other = {b: k[name] for b, k in encoders["kernels_bf16"].items()
                 if name in k}
        if other:
            entry["encoders"] = other
        kernels.append(entry)
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
    if sys.argv[1:2] == ["--md-rank"]:     # a rank of phase (p2)
        sys.exit(_md_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                          int(sys.argv[5]), int(sys.argv[6])))
    sys.exit(main())
