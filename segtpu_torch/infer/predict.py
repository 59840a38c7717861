"""Whole-image inference (port of ``segtpu/infer/predict.py``).

Same layout as the JAX package at the boundary: images (N,H,W[,1]) as
numpy in, probabilities (N,H,W,C) as numpy out. Inside, the batch runs
NCHW/channels_last on ``device`` under ``torch.inference_mode()``, with
the model in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from segtpu_torch import resolve_device


def output_activation(model):
    """Logits→probability map: per-pixel sigmoid for binary heads,
    softmax over channels for multiclass (n_classes > 1)."""
    if getattr(model, "n_classes", 1) > 1:
        return lambda lg: torch.softmax(lg, dim=1)
    return torch.sigmoid


def _model_param(model, dev: torch.device) -> torch.Tensor:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None
                                     and p.device.index != dev.index):
        raise ValueError(f"model is on {p.device}, not on {dev}")
    return p


def predict_proba(model, images, *, device="cuda") -> np.ndarray:
    """Probability maps (N,H,W,C) float32 for images (N,H,W[,1])."""
    dev = resolve_device(device)
    p = _model_param(model, dev)
    x = np.asarray(images, np.float32)
    if x.ndim == 3:
        x = x[..., None]
    if x.ndim != 4:
        raise ValueError(f"images must be (N,H,W[,1]); got {x.shape}")
    model.eval()
    with torch.inference_mode():
        t = torch.from_numpy(x).to(p.device).to(p.dtype)
        t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        probs = output_activation(model)(model(t))
        return probs.float().permute(0, 2, 3, 1).cpu().numpy()


def predict(model, images, threshold: float = 0.5, *,
            device="cuda") -> np.ndarray:
    """Binary masks (uint8) at the reference's 0.5 threshold."""
    return (predict_proba(model, images, device=device)
            > threshold).astype(np.uint8)
