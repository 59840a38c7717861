"""The traced run's profile, reduced to what the per-layer readers take.

``Tracer`` wraps ``torch.profiler`` (CPU and CUDA activities, shapes
recorded) around a bounded sub-window of the measured window, and the
benchmark's own spans (``portbench.fold``, the
sub-window itself) are ``record_function`` ranges in the same
timeline. ``reduce`` turns the finished profile into a ``Trace``: every
device operation (kernels, copies, sets) with its interval, the custom
ops' recorded shapes, the device's busy time (the union of its
operations' intervals) inside the sub-window, and the idle gaps
labelled by what the host was doing then.
Without a tracer's profile nothing here runs.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
# the idle gaps labelled one by one (the longest); the rest are summed
LABELLED_GAPS = 500


@dataclass
class Trace:
    """A profiled sub-window. Times in seconds; ``device_ops`` are (name,
    start, end) in the profiler's clock, ``ops`` (name, input shapes,
    input dtypes) of the CPU ops the readers ask for."""
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]]
    ops: List[Tuple[str, list, list]]
    idle_by_label: Dict[str, float] = field(default_factory=dict)
    device_by_name: Dict[str, float] = field(default_factory=dict)


class Tracer:
    """Spans always; a profile only between ``start`` and ``stop``."""

    def __init__(self, device, op_names=()):
        self.device = torch.device(device)
        self.op_names = tuple(op_names)
        self.prof = None
        self._window = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None:
            yield
            return
        with torch.profiler.record_function(name):
            yield

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts,
                                           record_shapes=True)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()

    def stop(self) -> None:
        self._sync()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Optional[Trace]:
        """The ``Trace`` of the profiled sub-window (None if none ran)."""
        if self.prof is None:
            return None
        return reduce_events(self.prof.events(), self.op_names)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _gaps(busy: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def _host_label(cpu: List[Tuple[float, float, str]], starts: List[float],
                spans: List[Tuple[float, float, str]], t: float) -> str:
    """The benchmark span and the innermost host operation at time t."""
    span = next((n for s, e, n in spans if s <= t < e), "outside spans")
    op, i = "Python, in no op", bisect.bisect_right(starts, t) - 1
    # the latest-starting event that still covers t is the innermost
    for j in range(i, max(-1, i - 4000), -1):
        s, e, n = cpu[j]
        if e > t:
            op = n
            break
    return f"{span}: {op}"


def reduce_events(events, op_names=()) -> Optional[Trace]:
    """A ``Trace`` from a finished profile's ``events()``: all times in
    the profiler's microseconds, converted to seconds."""
    from torch.autograd import DeviceType
    us = 1e-6
    window = None
    device_ops, ops, cpu, spans = [], [], [], []
    for e in events:
        s, t = e.time_range.start * us, e.time_range.end * us
        if e.name.startswith(SPAN_PREFIX):
            # the benchmark's spans (their device-side mirrors skipped)
            if e.device_type != DeviceType.CUDA:
                if e.name == WINDOW_SPAN:
                    window = (s, t)
                else:
                    spans.append((s, t, e.name))
        elif e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, s, t))
        else:
            cpu.append((s, t, e.name))
            if e.name in op_names:
                ops.append((e.name, list(e.input_shapes or []),
                            list(getattr(e, "input_dtypes", None) or [])))
    if window is None:
        return None
    lo, hi = window
    inside = [(n, max(s, lo), min(t, hi)) for n, s, t in device_ops
              if t > lo and s < hi]
    busy = _union([(s, t) for _, s, t in inside])
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, t in inside:
        by_name[n] += t - s
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps = sorted(_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])
    idle: Dict[str, float] = defaultdict(float)
    for s, t in gaps[:LABELLED_GAPS]:
        idle[_host_label(cpu, starts, spans, (s + t) / 2)] += t - s
    rest = sum(t - s for s, t in gaps[LABELLED_GAPS:])
    if rest:
        idle[f"{len(gaps) - LABELLED_GAPS} shorter gaps"] += rest
    return Trace(window_s=hi - lo,
                 busy_s=sum(t - s for s, t in busy),
                 device_ops=inside, ops=ops, idle_by_label=dict(idle),
                 device_by_name=dict(by_name))


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the idle time by
    what the host was doing, ``top`` of each, in seconds."""
    rank = lambda d: [[n[:160], v] for n, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(trace.device_by_name),
            "idle_gaps": rank(trace.idle_by_label)}
