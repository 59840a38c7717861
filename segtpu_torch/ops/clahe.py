"""CLAHE (contrast-limited adaptive histogram equalisation) on tensors
(port of ``segtpu/ops/clahe.py``).

OpenCV's algorithm, as the JAX op has it: per-tile 256-bin histograms,
clip and redistribution of the excess (with OpenCV's residual loop),
CDF look-up tables, and the bilinear blend of the four neighbouring
tiles' tables in f32 with the same operations in the same order, so the
uint8 result is the JAX op's bit for bit. The histogram is a
``scatter_add_`` of counts, not the JAX op's one-hot sum. Batched over
the leading dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_HIST_SIZE = 256


def _tile_luts(tiles: torch.Tensor, clip_limit_int: int) -> torch.Tensor:
    """(N, tY, tX, n) uint8 tiles → (N, tY, tX, 256) uint8 LUTs."""
    *lead, n = tiles.shape
    flat = tiles.reshape(-1, n).long()
    hist = torch.zeros(flat.shape[0], _HIST_SIZE, dtype=torch.int32,
                       device=tiles.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    if clip_limit_int > 0:
        clipped = torch.clamp(hist - clip_limit_int, min=0).sum(dim=-1)
        hist = torch.clamp(hist, max=clip_limit_int)
        redist = clipped // _HIST_SIZE
        residual = clipped - redist * _HIST_SIZE
        hist = hist + redist[:, None]
        # OpenCV: for (i = 0; i < 256 && residual > 0; i += step,
        # residual--) with step = max(256 / residual, 1): bins j·step,
        # j < residual, get +1
        bins = torch.arange(_HIST_SIZE, dtype=torch.int32,
                            device=tiles.device)
        step = torch.clamp(_HIST_SIZE // torch.clamp(residual, min=1),
                           min=1)[:, None]
        bump = ((bins % step) == 0) & ((bins // step) < residual[:, None])
        hist = hist + bump.to(torch.int32)
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    lut_scale = torch.tensor(_HIST_SIZE - 1, dtype=torch.float32) / \
        torch.tensor(n, dtype=torch.float32)
    lut = torch.clamp(torch.round(cdf * lut_scale.to(cdf.device)), 0, 255)
    return lut.to(torch.uint8).reshape(*lead, _HIST_SIZE)


def clahe(img: torch.Tensor, clip_limit: float = 2.0,
          tile_grid_size: tuple = (8, 8)) -> torch.Tensor:
    """OpenCV-parity CLAHE of uint8 images (…, H, W) → uint8 (…, H, W)."""
    if img.dtype != torch.uint8:
        img = img.to(torch.uint8)
    *lead, h, w = img.shape
    x = img.reshape(-1, h, w)
    n_img = x.shape[0]
    tiles_y, tiles_x = tile_grid_size
    pad_y = (tiles_y - h % tiles_y) % tiles_y
    pad_x = (tiles_x - w % tiles_x) % tiles_x
    src = x
    if pad_y or pad_x:
        # cv2 reflects (BORDER_REFLECT_101) at the bottom and right only
        src = F.pad(x[:, None].float(), (0, pad_x, 0, pad_y),
                    mode="reflect")[:, 0].to(torch.uint8)
    ph, pw = h + pad_y, w + pad_x
    th, tw = ph // tiles_y, pw // tiles_x
    tile_area = th * tw
    clip_int = 0
    if clip_limit > 0.0:
        clip_int = max(int(clip_limit * tile_area / _HIST_SIZE), 1)

    tiles = src.reshape(n_img, tiles_y, th, tiles_x, tw).permute(
        0, 1, 3, 2, 4).reshape(n_img, tiles_y, tiles_x, tile_area)
    lut_flat = _tile_luts(tiles, clip_int).reshape(n_img, -1)

    # blend over the unpadded image, cv2's convention: txf = x/tw − 0.5,
    # tx1 = floor(txf), the fraction taken before clamping
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    tyf = ys / th - 0.5
    txf = xs / tw - 0.5
    ty1 = torch.floor(tyf).to(torch.int64)
    tx1 = torch.floor(txf).to(torch.int64)
    ya = (tyf - ty1)[:, None]
    xa = (txf - tx1)[None, :]
    ty2 = torch.clamp(ty1 + 1, max=tiles_y - 1)
    tx2 = torch.clamp(tx1 + 1, max=tiles_x - 1)
    ty1 = torch.clamp(ty1, min=0)
    tx1 = torch.clamp(tx1, min=0)
    v = x.long()

    def gather(tyi, txi):
        idx = (tyi[:, None] * tiles_x + txi[None, :]) * _HIST_SIZE + v
        return torch.gather(lut_flat, 1, idx.reshape(n_img, -1)).reshape(
            n_img, h, w).to(torch.float32)

    res = (gather(ty1, tx1) * (1 - xa) * (1 - ya)
           + gather(ty1, tx2) * xa * (1 - ya)
           + gather(ty2, tx1) * (1 - xa) * ya
           + gather(ty2, tx2) * xa * ya)
    out = torch.clamp(torch.round(res), 0, 255).to(torch.uint8)
    return out.reshape(*lead, h, w)
