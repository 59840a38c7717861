"""Microscopy normalisation on the device (port of the array half of
``segtpu/data/preprocess.py``).

Canonical frames (uint8 (N, S, S) images at the target size) become model
inputs by the reference's chain (dataset.py:30-42): percentile clip
[2, 98] → truncate to uint8 → CLAHE(2.0, 8×8) → min-max to [0, 1]. The
percentiles use ``jnp.percentile``'s linear formula, operation for
operation, so the uint8 truncation agrees with the JAX package's bit for
bit. Outputs are NCHW (N, 1, S, S) float32 (the JAX package: NHWC).

Decoding and resizing image files into canonical frames
(``load_canonical``, ``load_canonical_images``) waits for the port's data
layer (ROADMAP A12).
"""

from __future__ import annotations

import torch

from segtpu_torch.ops.clahe import clahe


def _percentiles(x: torch.Tensor, q) -> torch.Tensor:
    """Linear-interpolated percentiles ``q`` (in %) of each row of x
    (N, M) float32 → (len(q), N), by ``jnp.percentile``'s steps:
    q/100·(M−1), floor and ceil, then low·(1−w) + high·w in f32."""
    srt = torch.sort(x, dim=-1).values
    n = float(x.shape[-1])
    qq = torch.tensor(q, dtype=torch.float32, device=x.device) / 100.0
    qq = qq * torch.tensor(n - 1.0, dtype=torch.float32, device=x.device)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1.0 - hw
    lo = srt[:, low.long().clamp(0, x.shape[-1] - 1)].T
    hi = srt[:, high.long().clamp(0, x.shape[-1] - 1)].T
    return lo * lw[:, None] + hi * hw[:, None]


def _normalize(images_u8: torch.Tensor, clip_percentiles=(2.0, 98.0),
               clip_limit: float = 2.0, tile_grid=(8, 8)) -> torch.Tensor:
    """(N, H, W) uint8 → (N, H, W) float32 in [0, 1]."""
    img_f = images_u8.to(torch.float32)
    n = img_f.shape[0]
    p_low, p_high = _percentiles(img_f.reshape(n, -1), clip_percentiles)
    clipped = torch.minimum(torch.maximum(img_f, p_low[:, None, None]),
                            p_high[:, None, None])
    # numpy's .astype(np.uint8) truncates toward zero (dataset.py:38)
    eq = clahe(torch.floor(clipped).to(torch.uint8), clip_limit=clip_limit,
               tile_grid_size=tile_grid).to(torch.float32)
    mn = torch.amin(eq, dim=(1, 2), keepdim=True)
    mx = torch.amax(eq, dim=(1, 2), keepdim=True)
    return (eq - mn) / (mx - mn + 1e-8)


def normalize_microscopy_image(image: torch.Tensor,
                               clip_percentiles=(2.0, 98.0),
                               clip_limit: float = 2.0,
                               tile_grid=(8, 8)) -> torch.Tensor:
    """One image: uint8 (H, W) → float32 (H, W) in [0, 1]."""
    return _normalize(image[None], clip_percentiles, clip_limit,
                      tile_grid)[0]


def normalize_canonical(images_u8: torch.Tensor) -> torch.Tensor:
    """(N, S, S) uint8 → (N, 1, S, S) float32 on the images' device."""
    return _normalize(images_u8)[:, None]


def scale_canonical(images_u8: torch.Tensor) -> torch.Tensor:
    """The normalize=False path (dataset.py:57): /255 only,
    (N, S, S) uint8 → (N, 1, S, S) float32."""
    return (images_u8.to(torch.float32) / 255.0)[:, None]
