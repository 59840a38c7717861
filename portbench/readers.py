"""Arithmetic that several per-layer readers share. Each takes the
``ctx`` a reader gets (``run.run_cell``): ``trace`` (``trace.Trace``, or
None), ``units`` (folds profiled), ``untraced_units`` and ``untraced_s``
(the window's units after the profiled ones, and their seconds without
the profiler), ``trained_per_unit`` and ``validated_per_unit`` (images
in one unit), ``forward_flops`` (one image's forward,
``counts.forward_macs`` × 2), ``counters`` and the cell's ``model_cfg``
and ``traffic``. A reader with nothing to read returns None.

The profiler's own work lengthens the gaps between a replayed graph's
kernels, so a profiled unit takes longer than one without it. Shares of
the time (idle, MFU) therefore divide by the untraced units' time per
unit; the device's busy time per unit comes from the profile."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from portbench import counts

_DTYPES = {"c10::BFloat16": torch.bfloat16, "float": torch.float32}


def kind_share(ctx, kind: str) -> Optional[float]:
    """% of the device's operation time spent in kernels of ``kind``
    (``counts.kernel_kind``)."""
    tr = ctx.trace
    if tr is None or not tr.device_by_name:
        return None
    total = sum(tr.device_by_name.values())
    part = sum(t for n, t in tr.device_by_name.items()
               if counts.kernel_kind(n) == kind)
    return 100.0 * part / total if total > 0 else None


def unit_s(ctx) -> Optional[float]:
    """Seconds a unit takes without the profiler, where the run profiled
    the device and timed units after it."""
    tr = ctx.trace
    if tr is None or not tr.device_ops or ctx.untraced_units <= 0 \
            or ctx.untraced_s <= 0:
        return None
    return ctx.untraced_s / ctx.untraced_units


def idle_share(ctx) -> Optional[float]:
    """% of a unit's time in which no operation ran on the device: the
    profiled units' busy time per unit over an untraced unit's time."""
    t = unit_s(ctx)
    if t is None or ctx.units <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.units / t)


def mfu(ctx, flops_per_unit: float) -> Optional[float]:
    """% of the bf16 peak that ``flops_per_unit`` of model work in an
    untraced unit's time make."""
    t = unit_s(ctx)
    if t is None or flops_per_unit <= 0:
        return None
    return 100.0 * flops_per_unit / t / counts.PEAK_BF16


def roofline(ctx, op: str, kernels: Sequence[str],
             bytes_ops: Callable[[list, torch.dtype], tuple]
             ) -> Optional[float]:
    """% of its roofline: the least time of every recorded call of the
    custom op ``op`` (``counts.bound`` of ``bytes_ops(shapes, dtype)``)
    over the device time of the kernels named ``kernels``."""
    tr = ctx.trace
    if tr is None:
        return None
    least_ms = 0.0
    for name, shapes, dtypes in tr.ops:
        if name != op:
            continue
        dt = _DTYPES.get(dtypes[0] if dtypes else "", torch.bfloat16)
        least_ms += counts.bound(*bytes_ops(shapes, dt), dt)[0]
    spent = sum(t for n, t in tr.device_by_name.items()
                if any(k in n for k in kernels))
    if least_ms <= 0 or spent <= 0:
        return None
    return 100.0 * least_ms * 1e-3 / spent
