"""Tracing and profiling hooks (port of ``segtpu/core/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the host and, where
  CUDA is available, the device, written into ``log_dir`` as a Chrome
  trace (``chrome://tracing``, Perfetto, TensorBoard's profile plugin);
- ``annotate(name)``: a named range inside a trace
  (``torch.profiler.record_function``);
- ``StepTimer``: per-phase wall-clock aggregation with percentile
  summaries, copied from the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block's CPU and CUDA activity; on exit write
    ``trace.<pid>.<ns>.json`` (Chrome trace format) into ``log_dir``
    (default: ``segtpu_torch_trace`` in the temporary directory). Yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "segtpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def annotate(name: str):
    """Named range inside a trace (host-side phase labelling)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates named phase durations on the host clock; reports
    mean/p50/p99.

    CUDA work is asynchronous: a phase that only enqueues kernels is timed
    as its enqueue, not its device work, unless the caller synchronises
    (``torch.cuda.synchronize()``) inside the phase."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:24} n={s['count']:5d} "
                         f"total={s['total_s']:8.2f}s "
                         f"mean={s['mean_ms']:7.2f}ms p99={s['p99_ms']:7.2f}ms")
        return "\n".join(lines)
