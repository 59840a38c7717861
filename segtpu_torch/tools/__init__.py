"""Command-line tools of the port, counterparts of the JAX package's
``tools/``: ``kernel_bench`` (conv3×3+BN+ReLU and upsample+concat) and
``fused_block_bench`` (the fused decoder pair), each run as
``python -m segtpu_torch.tools.<name>`` and callable as ``main(argv)``.

Shared here: the timer and the device label that every result carries.
"""

from __future__ import annotations

import time

import torch


def device_label(device: torch.device) -> dict:
    """What a result ran on and which clock timed it. A CPU run is timed
    with the host clock and is never a device number."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "clock": "cuda_events"}
    return {"device": device.type, "clock": "host"}


def time_ms(fn, device: torch.device, iters: int = 20) -> float:
    """Mean time of ``fn()`` in ms over ``iters`` back-to-back calls after
    3 warm-up calls: CUDA events on a CUDA device, the host clock around
    the calls elsewhere."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def run_case(kernel, library, plain, device: torch.device,
             iters: int = 20) -> dict:
    """One bench case: the kernel's result against its plain version
    (``max_abs_err``, and ``ref_max_abs`` to scale it), then the library
    composition's and the kernel's times, in that order."""
    out, ref = kernel().float(), plain().float()
    rec = dict(max_abs_err=(out - ref).abs().max().item(),
               ref_max_abs=ref.abs().max().item())
    del out, ref
    rec["library_ms"] = time_ms(library, device, iters)
    rec["kernel_ms"] = time_ms(kernel, device, iters)
    return rec


def seeded(device: torch.device):
    """``randn(*shape)`` and ``rand(*shape)`` in float32 on ``device`` from
    one generator seeded with 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return (lambda *s: torch.randn(*s, generator=gen, device=device),
            lambda *s: torch.rand(*s, generator=gen, device=device))
