"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``limits/<workload>.json``: ``{"numbers": {name: limit}}``).

A number at or under its limit passes; one that is missing or not
finite fails. Per-parameter ("leaf") readings are taken over the larger
of the reference's reading of that leaf and of the median leaf.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List, Tuple

# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves by round-off alone (a convolution's bias ahead of a
# train-mode BatchNorm): its change is not compared
ZERO_GRAD_SHARE = 1e-3


def counted_leaves(grad0: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad0.values())
    return [n for n, g in grad0.items() if g >= ZERO_GRAD_SHARE * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Iterable[str]) -> List[float]:
    """|prog − ref| / max(ref, median ref) of each of ``leaves``."""
    leaves = list(leaves)
    med = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in leaves]


def leaf_diffs(prog: Dict, ref: Dict, leaves: Iterable[str]) -> List[float]:
    """‖prog − ref‖ / max(‖ref‖, median ‖ref‖) of each of ``leaves``:
    tensors by name, on any device (``prog``'s moved to ``ref``'s)."""
    leaves = list(leaves)
    norms = {n: ref[n].norm().item() for n in leaves}
    med = statistics.median(norms.values())
    return [(prog[n].to(ref[n].device) - ref[n]).norm().item()
            / max(norms[n], med, 1e-30) for n in leaves]


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def judge(numbers: Dict[str, float], limits: Dict
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) of the numbers the limits
    name; the others were read, not compared."""
    checks, ok = {}, True
    for name, limit in limits.get("numbers", {}).items():
        v = numbers.get(name)
        ok = ok and v is not None and math.isfinite(v) and v <= limit
        checks[name] = {"value": v, "limit": limit}
    return ok and bool(checks), checks


def print_checks(checks: Dict[str, Dict[str, float]], file=sys.stderr):
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=file, flush=True)
