"""Segmentation metrics (port of ``segtpu/metrics/metrics.py``).

- ``calculate_metrics``: threshold 0.5 → confusion counts →
  precision/recall/F1/IoU/accuracy with epsilon 1e-7, as 0-d tensors on
  the input's device (no host sync);
- ``iou_score``: IoU from logits, optional connected-component cleanup;
- ``post_process``: small-object removal, numpy on the host (labelling is
  sequential), post hoc only;
- ``compute_foreground_ratio``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_EPS = 1e-7


def calculate_metrics(pred: torch.Tensor, target: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Per-batch metrics from probabilities (post-sigmoid) and binary
    targets, any layout; a dict of 0-d tensors."""
    p = (pred > 0.5).to(torch.float32).reshape(-1)
    t = target.reshape(-1).to(torch.float32)

    tp = torch.sum(p * t)
    fp = torch.sum(p * (1.0 - t))
    fn = torch.sum((1.0 - p) * t)
    tn = torch.sum((1.0 - p) * (1.0 - t))

    precision = tp / (tp + fp + _EPS)
    recall = tp / (tp + fn + _EPS)
    f1 = 2 * precision * recall / (precision + recall + _EPS)
    iou = tp / (tp + fp + fn + _EPS)
    accuracy = (tp + tn) / (tp + tn + fp + fn + _EPS)

    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "iou": iou,
        "accuracy": accuracy,
    }


def post_process(prediction: np.ndarray, min_size: int = 15) -> np.ndarray:
    """Remove connected components smaller than ``min_size`` pixels.

    Host-side (numpy/scipy); reference: utils.py:58-84."""
    binary = (_host(prediction) > 0.5).astype(np.uint8)
    try:
        from scipy import ndimage
        labeled, num = ndimage.label(binary)
        if num == 0:
            return binary
        sizes = ndimage.sum(binary, labeled, range(1, num + 1))
    except ImportError:  # pragma: no cover - scipy is normally present
        labeled, num, sizes = _label_fallback(binary)
        if num == 0:
            return binary
    small = np.asarray(sizes) < min_size
    remove = small[labeled - 1]
    binary[remove] = 0
    return binary


def _label_fallback(binary: np.ndarray):
    """4-connectivity connected-component labeling (scipy-free fallback).

    Run-length formulation: each row's foreground runs are extracted with
    one vectorized diff over the whole image, and union-find operates on
    runs (for typical masks orders of magnitude fewer than pixels), with
    a two-pointer overlap sweep between consecutive rows. Labels follow
    raster order of each component's first pixel — the same convention as
    ``scipy.ndimage.label`` with the default cross structure, so the two
    paths are drop-in interchangeable (pinned by tests/test_torch_losses.py).
    """
    H, W = binary.shape
    edges = np.zeros((H, W + 2), dtype=np.int8)
    edges[:, 1:-1] = binary != 0
    d = np.diff(edges, axis=1)
    start_rows, start_cols = np.nonzero(d == 1)   # inclusive start col
    _, end_cols = np.nonzero(d == -1)             # exclusive end col
    n_runs = start_rows.size
    out = np.zeros((H, W), dtype=np.int32)
    if n_runs == 0:
        return out, 0, np.array([])

    parent = np.arange(n_runs)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # np.nonzero is row-major, so each row's runs are a contiguous,
    # column-sorted slice [row_first[r], row_last[r]).
    row_first = np.searchsorted(start_rows, np.arange(H))
    row_last = np.searchsorted(start_rows, np.arange(H), side="right")
    for r in range(1, H):
        i, i_end = row_first[r - 1], row_last[r - 1]
        j, j_end = row_first[r], row_last[r]
        while i < i_end and j < j_end:
            if start_cols[i] < end_cols[j] and start_cols[j] < end_cols[i]:
                ri, rj = find(i), find(j)
                if ri != rj:
                    # keep the smaller run index as root: the component's
                    # root is then its first run in raster order
                    if ri < rj:
                        parent[rj] = ri
                    else:
                        parent[ri] = rj
            if end_cols[i] < end_cols[j]:
                i += 1
            else:
                j += 1

    roots = np.fromiter((find(i) for i in range(n_runs)), np.int64, n_runs)
    uniq_roots, run_label0 = np.unique(roots, return_inverse=True)
    num = uniq_roots.size
    lengths = end_cols - start_cols
    # scatter each run's label into the flat output in one vectorized pass
    flat_starts = start_rows.astype(np.int64) * W + start_cols
    csum = np.cumsum(lengths)
    offsets = np.arange(csum[-1]) - np.repeat(csum - lengths, lengths)
    out.reshape(-1)[np.repeat(flat_starts, lengths) + offsets] = np.repeat(
        run_label0 + 1, lengths)
    sizes = np.bincount(run_label0, weights=lengths).astype(np.int64)
    return out, num, sizes


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def iou_score(pred, target, apply_post_processing: bool = False,
              min_size: int = 25) -> float:
    """IoU from logits (tensor or array), with optional post-processing.
    The sigmoid runs in float64 numpy on the host, as in the JAX package:
    logits within ~1e-6 of 0 can threshold otherwise than the training
    metrics' f32/bf16 sigmoid. Post-hoc use only."""
    pred_sigmoid = 1.0 / (1.0 + np.exp(-_host(pred)))
    target_np = _host(target)

    if apply_post_processing:
        pred_binary = post_process(pred_sigmoid, min_size=min_size)
    else:
        pred_binary = (pred_sigmoid > 0.5).astype(np.uint8)
    target_binary = (target_np > 0.5).astype(np.uint8)

    intersection = np.sum(pred_binary * target_binary)
    union = np.sum((pred_binary + target_binary) > 0)
    return float(intersection / (union + _EPS))


def compute_foreground_ratio(masks=None, image_type: str = "W",
                             data_dir: str = "manual_labels",
                             img_size=(256, 256), *, device="cuda") -> float:
    """Fraction of foreground pixels (utils.py:9-23) of an iterable or
    stack of masks, or (``masks=None``, the reference's signature) of the
    ``image_type`` masks of ``data_dir``, resized to ``img_size`` on
    ``device``."""
    if masks is None:
        from segtpu_torch.data.discovery import load_original_data
        from segtpu_torch.data.loader import CellSegmentationDataset
        data = load_original_data(data_dir, image_type)
        ds = CellSegmentationDataset(data["image_paths"], data["mask_paths"],
                                     img_size=img_size, device=device)
        masks = [ds.materialize()[1]]
    total = 0
    fg = 0.0
    for m in masks:
        arr = _host(m)
        fg += float(arr.sum())
        total += arr.size
    ratio = fg / max(total, 1)
    print(f"Foreground (cell) pixels: {ratio*100:.2f}%")
    return ratio
