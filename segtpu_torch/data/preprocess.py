"""Preprocessing on the device (port of ``segtpu/data/preprocess.py``).

The reference's per-sample CPU chain (dataset.py:44-66) is two stages:

1. ``load_canonical`` / ``load_canonical_images``: host decode, then one
   batched device resize per raw shape group (images INTER_AREA, masks
   INTER_NEAREST) into *canonical frames*: host uint8 (N, S, S) images
   and binary masks at ``img_size``.
2. ``normalize_canonical``: percentile clip [2, 98] → truncate to uint8 →
   CLAHE(2.0, 8×8) → min-max to [0, 1], on the device. The percentiles
   use ``jnp.percentile``'s linear formula, operation for operation, so
   the uint8 truncation agrees with the JAX package's bit for bit.
   Outputs are NCHW (N, 1, S, S) float32 (the JAX package: NHWC).

Augmentation (``segtpu_torch/data/augment.py``) slots between the two.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.data.io import decode_gray_batch
from segtpu_torch.ops.clahe import clahe
from segtpu_torch.ops.resize import resize_area, resize_nearest


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """cv2-style round half up to uint8: floor(clip(x, 0, 255) + 0.5)."""
    return torch.floor(torch.clamp(x, 0, 255) + 0.5).to(torch.uint8)


# Files per decode chunk. One producer thread decodes chunk k+1 with the
# native reader (C, the GIL released) while the main thread resizes chunk
# k on the device.
PREFETCH_CHUNK = 64


def _decode_resize_pipelined(image_paths: Sequence[str],
                             mask_paths: Optional[Sequence[str]],
                             img_size: Tuple[int, int],
                             chunk: Optional[int], device: torch.device):
    """The chunked decode → resize pipeline (images alone, or pairs).

    Producer thread: per chunk, one threaded native batch decode. Main
    thread: group the chunk by raw shape, copy each group to the device,
    resize it there and keep the result on the device. At the end one
    device → host copy of every group's frames.

    Returns (images (N, S, S) u8, masks or None, raw shapes (N, 2) i32),
    on the host."""
    n = len(image_paths)
    pairs = mask_paths is not None
    raw_shapes = np.zeros((n, 2), np.int32)
    if n == 0:
        empty = np.zeros((0, *img_size), np.uint8)
        return empty, (empty.copy() if pairs else None), raw_shapes
    chunk = n if not chunk or chunk <= 0 else min(chunk, n)
    q: "queue.Queue" = queue.Queue(maxsize=2)          # double buffer

    def producer():
        try:
            for s in range(0, n, chunk):
                idx = list(range(s, min(n, s + chunk)))
                ps = [image_paths[i] for i in idx]
                if pairs:
                    ps += [mask_paths[i] for i in idx]
                q.put((idx, decode_gray_batch(ps)))
            q.put(None)
        except BaseException as e:    # handed to the consumer, raised there
            q.put(e)

    th = threading.Thread(target=producer, daemon=True,
                          name="segtpu-torch-decode-prefetch")
    th.start()
    order, frames = [], []       # image indices; device (G, [2,] S, S)
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            idx, decoded = item
            m = len(idx)
            groups: dict = {}
            for j, i in enumerate(idx):
                img = decoded[j]
                msk = decoded[m + j] if pairs else None
                if pairs and msk.shape != img.shape:
                    # a mask not at its image's raw shape: nearest to it
                    msk = resize_nearest(torch.from_numpy(msk),
                                         img.shape).numpy()
                raw_shapes[i] = img.shape
                groups.setdefault(img.shape, []).append((i, img, msk))
            for items in groups.values():
                raw = torch.from_numpy(np.stack(
                    [im for _, im, _ in items])).to(device)
                out = _round_u8(resize_area(raw, img_size))
                if pairs:
                    raw = torch.from_numpy(np.stack(
                        [mk for _, _, mk in items])).to(device)
                    cm = (resize_nearest(raw, img_size) > 0).to(torch.uint8)
                    out = torch.stack([out, cm], 1)
                order.extend(i for i, _, _ in items)
                frames.append(out)
        th.join()
    except BaseException:
        # the consumer failed mid-stream: the producer may be blocked on
        # the full queue; drain it until it parks its sentinel or error,
        # so that the thread and its decode buffers go before we re-raise
        while th.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        raise
    host = torch.cat(frames).cpu().numpy()     # the one device → host copy
    canon = np.empty_like(host)
    canon[np.asarray(order)] = host
    if pairs:
        return canon[:, 0], canon[:, 1], raw_shapes
    return canon, None, raw_shapes


def load_canonical_images(image_paths: Sequence[str],
                          img_size: Tuple[int, int] = (256, 256),
                          chunk: Optional[int] = PREFETCH_CHUNK, *,
                          device="cuda") -> np.ndarray:
    """Images alone (the inference path): decode, resize on ``device``
    (default ``cuda``; raises without it unless ``device='cpu'``) →
    host uint8 (N, S, S)."""
    imgs, _, _ = _decode_resize_pipelined(
        list(image_paths), None, tuple(img_size), chunk,
        resolve_device(device))
    return imgs


def load_canonical(image_paths: Sequence[str], mask_paths: Sequence[str],
                   img_size: Tuple[int, int] = (256, 256),
                   return_raw_shapes: bool = False,
                   chunk: Optional[int] = PREFETCH_CHUNK, *,
                   device="cuda"):
    """Decode and resize every pair on ``device`` into canonical frames:
    (images (N, S, S) uint8, masks (N, S, S) uint8 in {0, 1}), on the
    host. Mixed raw shapes are grouped; decode and resize overlap in
    ``chunk``-file chunks (``chunk=None``: one batch). With
    ``return_raw_shapes`` also the raw (H, W) of each image, (N, 2) int32,
    for the raw-frame-aware augmentations (``augment.RAW_FRAME_AWARE``)."""
    if len(image_paths) != len(mask_paths):
        raise ValueError(f"image/mask path counts differ: "
                         f"{len(image_paths)} vs {len(mask_paths)}")
    imgs, masks, raw_shapes = _decode_resize_pipelined(
        list(image_paths), list(mask_paths), tuple(img_size), chunk,
        resolve_device(device))
    if return_raw_shapes:
        return imgs, masks, raw_shapes
    return imgs, masks


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
