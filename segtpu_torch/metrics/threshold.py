"""Decision-threshold sweep (port of ``segtpu/metrics/threshold.py``).

Every threshold's confusion counts are computed on the device from one
probability tensor, then fetched once; precision, recall, F1, IoU and
accuracy follow in float64 with ``calculate_metrics``' epsilon, so the
value at threshold 0.5 equals ``calculate_metrics``'.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

_EPS = 1e-7  # as calculate_metrics (metrics.py)


def _sweep_counts(probs: torch.Tensor, targets: torch.Tensor,
                  thresholds: torch.Tensor) -> torch.Tensor:
    """(T, 4) [tp, fp, fn, tn] for every threshold, exact int64 counts."""
    p = probs.reshape(-1)
    t = targets.reshape(-1) > 0.5
    n_pos = t.sum()
    rows = []
    for thr in thresholds:
        pb = p > thr
        tp = (pb & t).sum()
        fp = pb.sum() - tp
        fn = n_pos - tp
        rows.append(torch.stack([tp, fp, fn, p.numel() - tp - fp - fn]))
    return torch.stack(rows)


def sweep_thresholds(probs, masks,
                     thresholds: Optional[Sequence[float]] = None,
                     metric: str = "iou") -> Dict:
    """Binary-segmentation metrics at each threshold.

    ``probs``: probabilities (tensor or array, any shape); ``masks``:
    same-shape binary targets. Default grid 0.05..0.95 in steps of 0.05.
    Returns {'thresholds', 'precision', 'recall', 'f1', 'iou', 'accuracy'
    (numpy arrays of length T), 'best_threshold', 'best_value',
    'metric'}; best_* maximise ``metric`` (ties → the lowest threshold).
    """
    if thresholds is None:
        thresholds = np.arange(1, 20, dtype=np.float32) * 0.05
    thr = np.asarray(thresholds, dtype=np.float32)
    if thr.ndim != 1 or thr.size == 0:
        raise ValueError("thresholds must be a non-empty 1-D sequence")
    if metric not in ("precision", "recall", "f1", "iou", "accuracy"):
        raise ValueError(f"unknown metric '{metric}'")
    p = torch.as_tensor(probs)
    m = torch.as_tensor(masks, device=p.device)
    c = _sweep_counts(p, m, torch.from_numpy(thr).to(p.device)).cpu()
    c = c.numpy().astype(np.float64)
    tp, fp, fn, tn = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    precision = tp / (tp + fp + _EPS)
    recall = tp / (tp + fn + _EPS)
    out = {
        "thresholds": thr.astype(np.float64),
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / (precision + recall + _EPS),
        "iou": tp / (tp + fp + fn + _EPS),
        "accuracy": (tp + tn) / (tp + tn + fp + fn + _EPS),
    }
    best = int(np.argmax(out[metric]))
    out["metric"] = metric
    out["best_threshold"] = float(thr[best])
    out["best_value"] = float(out[metric][best])
    return out
