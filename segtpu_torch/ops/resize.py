"""Image resizing (port of ``segtpu/ops/resize.py``, the part the port's
path needs: ``resize_bilinear`` for ``UNetWithBackbone``'s
``return_features``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
