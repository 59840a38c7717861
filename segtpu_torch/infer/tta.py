"""Test-time augmentation: D4 symmetry-averaged inference (port of
``segtpu/infer/tta.py``).

Sigmoid (or, multiclass, channel-softmax) probabilities are averaged over
the dihedral group of the image plane: the 8 exact symmetries (4
rotations × optional transpose) for square inputs, the 4 shape-preserving
ones (no flip, horizontal, vertical, both) for rectangular inputs, in the
JAX package's element order. The elements act on NHWC tensors as views
(``transpose``/``rot90``/``flip``); ``nhwc_forward`` makes each
transformed batch ``channels_last``-contiguous before the model, since the
kernels take only NHWC-contiguous operands. The variants run one after
another with a running f32 sum, so peak memory stays about one forward.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.infer.predict import (model_param, nhwc_forward,
                                        output_activation)

# A D4 element acts on NHWC as rot90^k(transpose^t(x)); (k, t) pairs:
D4_ELEMENTS: Tuple[Tuple[int, int], ...] = tuple(
    (k, t) for t in (0, 1) for k in range(4))


def _apply_d4(x: torch.Tensor, k: int, t: int) -> torch.Tensor:
    if t:
        x = x.transpose(1, 2)
    if k:
        x = torch.rot90(x, k, dims=(1, 2))
    return x


def _invert_d4(y: torch.Tensor, k: int, t: int) -> torch.Tensor:
    if k:
        y = torch.rot90(y, -k, dims=(1, 2))
    if t:
        y = y.transpose(1, 2)
    return y


def _apply_flips(x: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    if fh:
        x = torch.flip(x, dims=(2,))
    if fv:
        x = torch.flip(x, dims=(1,))
    return x


def tta_elements(square: bool) -> Tuple[Tuple[int, int], ...]:
    """The group elements used for a given input aspect."""
    if square:
        return D4_ELEMENTS
    # (fh, fv) flip flags: each self-inverse, the four form a group
    return ((0, 0), (1, 0), (0, 1), (1, 1))


def _symmetrized(fwd, x: torch.Tensor) -> torch.Tensor:
    """The mean over ``tta_elements`` of each element's inverse applied to
    ``fwd`` of the transformed NHWC batch, summed in f32 in element
    order."""
    square = x.shape[1] == x.shape[2]
    elems = tta_elements(square)
    acc = None
    for a, b in elems:
        if square:
            p = _invert_d4(fwd(_apply_d4(x, a, b)), a, b)
        else:
            p = _apply_flips(fwd(_apply_flips(x, a, b)), a, b)
        p = p.float()
        acc = p if acc is None else acc + p
    return acc / len(elems)


def tta_predict_proba(model, images, *, device="cuda") -> np.ndarray:
    """Symmetry-averaged probabilities (B,H,W,C) float32 for a batch
    (B,H,W,C): sigmoid for binary models, channel softmax for multiclass
    (each element's map lies on the probability simplex, so their mean
    does too). The model runs in eval mode under ``inference_mode`` on
    ``device``, in whatever autocast the caller holds."""
    dev = resolve_device(device)
    p = model_param(model, dev)
    x = np.asarray(images, np.float32)
    if x.ndim != 4:
        raise ValueError(f"expected (B,H,W,C) batch, got shape {x.shape}")
    act = output_activation(model, dim=-1)
    model.eval()
    with torch.inference_mode():
        t = torch.from_numpy(x).to(p.device).to(p.dtype)
        probs = _symmetrized(lambda v: act(nhwc_forward(model, v)), t)
        return probs.cpu().numpy()


def tta_predict(model, images, threshold: float = 0.5, *,
                device="cuda") -> np.ndarray:
    """Symmetry-averaged binary masks at the reference's 0.5 threshold."""
    return (tta_predict_proba(model, images, device=device)
            > threshold).astype(np.uint8)


def d4_average_apply(apply_fn, out_transform=torch.sigmoid):
    """Wrap a square-input ``apply_fn(x: (B,S,S,Cin)) -> (B,S,S,Cout)``
    (NHWC tensors) into its D4 symmetry average in ``out_transform``
    space (probability space by default, as :func:`tta_predict_proba`).

    The wrapped function is a drop-in ``apply_fn`` for the tiled predictor
    (``segtpu_torch/infer/tiled.py``): tiles are square, so the full
    8-element group applies per tile, and blending then averages
    probabilities that are already symmetrized."""

    def wrapped(x):
        if x.shape[1] != x.shape[2]:
            raise ValueError(f"d4_average_apply needs square tiles, got "
                             f"{tuple(x.shape)}")
        return _symmetrized(lambda v: out_transform(apply_fn(v)), x)

    return wrapped
