"""Image resizing (port of ``segtpu/ops/resize.py``).

The reference resizes images with ``cv2.resize(..., INTER_AREA)`` and
masks with ``INTER_NEAREST`` (dataset.py:50-51). ``resize_area`` applies
the JAX package's weight matrices (exact fractional coverage; half-pixel
bilinear when enlarging) as two float32 ``torch.matmul``s over the
trailing (H, W) dims; ``resize_nearest`` gathers cv2's nearest indices.
Unlike the JAX functions, which guess that a trailing dim ≤ 8 holds
channels, these always take the trailing two dims as (H, W).

On CUDA the matmuls run in full float32 whatever the caller has set:
``torch.backends.cuda.matmul.allow_tf32`` is turned off around them and
restored, since TF32 would round the operands to 10 mantissa bits and
move the canonical frames by up to a few levels.

``resize_bilinear`` (``F.interpolate``) serves
``UNetWithBackbone``'s ``return_features``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=256)
def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic matrix of fractional coverage:
    output cell i covers the source interval [i·s, (i+1)·s), s = in/out,
    and each source pixel contributes its overlap / s (cv2 INTER_AREA
    for a scale ≤ 1)."""
    s = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo, hi = i * s, (i + 1) * s
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap / s
    return w.astype(np.float32)


@lru_cache(maxsize=256)
def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) half-pixel-centre bilinear weights with edge
    clamping (torch ``align_corners=False``, cv2 INTER_LINEAR)."""
    s = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        x = (i + 0.5) * s - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        a = np.clip(x0, 0, in_size - 1)
        b = np.clip(x0 + 1, 0, in_size - 1)
        w[i, a] += 1.0 - frac
        w[i, b] += frac
    return w.astype(np.float32)


@lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """cv2 INTER_NEAREST source indices: floor(dst · in/out)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def _apply_separable(img: torch.Tensor, wh: np.ndarray,
                     ww: np.ndarray) -> torch.Tensor:
    """(..., H, W) → (..., out_h, out_w) float32: contract H with the
    (out_h, H) weights, then W with the (out_w, W) ones (the JAX
    package's order)."""
    dev = img.device
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(torch.from_numpy(wh).to(dev),
                           img.to(torch.float32))
        return torch.matmul(out, torch.from_numpy(ww).to(dev).T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def resize_area(img: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.resize(img, (w, h), INTER_AREA) of the trailing (H, W) dims,
    float32 out (not rounded). Exact area weights on an axis that shrinks;
    cv2 switches to INTER_LINEAR when enlarging in both dims, which this
    mirrors; an axis that grows while the other shrinks takes bilinear
    weights."""
    out_h, out_w = out_hw
    h, w = img.shape[-2:]
    if out_h >= h and out_w >= w:
        return _apply_separable(img, _bilinear_weights(h, out_h),
                                _bilinear_weights(w, out_w))
    wh = _area_weights(h, out_h) if out_h <= h else _bilinear_weights(h, out_h)
    ww = _area_weights(w, out_w) if out_w <= w else _bilinear_weights(w, out_w)
    return _apply_separable(img, wh, ww)


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.resize(..., INTER_NEAREST) of the trailing (H, W) dims; keeps
    the dtype (dataset.py:51, the mask resize)."""
    out_h, out_w = out_hw
    h, w = img.shape[-2:]
    ih = torch.from_numpy(_nearest_index(h, out_h)).to(img.device)
    iw = torch.from_numpy(_nearest_index(w, out_w)).to(img.device)
    return img.index_select(-2, ih).index_select(-1, iw)


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Half-pixel bilinear (align_corners=False, no antialias) resize of
    the trailing (H, W) dims; float32 output, as in the JAX package."""
    x = img.float()
    lead = x.shape[:-2]
    if x.dim() != 4:
        x = x.reshape(-1, 1, *x.shape[-2:])
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.reshape(*lead, *out_hw)
