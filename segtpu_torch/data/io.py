"""Host-side image IO: grayscale TIFF decode (cached) and synthetic
fixtures (port of ``segtpu/data/io.py``).

Decoding is the only host-side stage of the input pipeline; resize,
normalisation and augmentation run on the device. Decoded arrays are
cached by (path, mtime), so CV folds and sweeps never decode a file twice.

Every file goes through the port's native reader
(``segtpu_torch/data/native.py``). Pillow reads, one file at a time, only
a variant that reader refuses, and only where Pillow is installed;
otherwise the decode raises, naming the file. ``decode_counts()`` says how
many files each decoder has read. 16-bit data maps to 8 bits by /256
unconditionally, on both paths, as ``cv2.IMREAD_GRAYSCALE`` does
(dataset.py:46). ``write_tiff`` needs only numpy.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Tuple

import numpy as np

from segtpu_torch.data.native import native_decode_batch, native_decode_gray

_DECODE_CACHE: Dict[Tuple[str, float], np.ndarray] = {}
_CACHE_MAX = 4096
_COUNTS = {"native": 0, "pil": 0}
_LOCK = threading.Lock()


def decode_counts() -> Dict[str, int]:
    """Files decoded so far by the native reader and by Pillow (cache hits
    are not decodes)."""
    with _LOCK:
        return dict(_COUNTS)


def reset_decode_counts() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def _keep(key: Tuple[str, float], arr: np.ndarray, how: str) -> np.ndarray:
    with _LOCK:
        _COUNTS[how] += 1
        if len(_DECODE_CACHE) >= _CACHE_MAX:
            _DECODE_CACHE.clear()
        _DECODE_CACHE[key] = arr
    return arr


def _key(path: str) -> Tuple[str, float]:
    return path, os.path.getmtime(path)


def decode_gray(path: str) -> np.ndarray:
    """Decode an image file to a grayscale uint8 (H, W) array."""
    key = _key(path)
    hit = _DECODE_CACHE.get(key)
    if hit is not None:
        return hit
    arr = native_decode_gray(path)
    if arr is not None:
        return _keep(key, arr, "native")
    return _decode_gray_pil(path, key)


def _decode_gray_pil(path: str, key: Tuple[str, float]) -> np.ndarray:
    """Pillow's decode of one file the native reader refused. Colour
    converts with the ITU-R 601 luma transform (as cv2.IMREAD_GRAYSCALE)."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"{path}: the native TIFF reader does not support this file "
            "(not an 8/16-bit one-sample strip TIFF with no, LZW or "
            "PackBits compression) and Pillow is not installed") from exc
    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B"):
            arr = np.asarray(im, dtype=np.float32)
            arr = np.clip(arr / 256.0, 0, 255).astype(np.uint8)
        elif im.mode == "I":
            # 32-bit container: scale by the observed bit depth (16-bit
            # data stored as mode "I" is common for TIFF)
            arr = np.asarray(im, dtype=np.float32)
            arr = np.clip(arr / 256.0 if arr.max() > 255 else arr, 0, 255)
            arr = arr.astype(np.uint8)
        else:
            arr = np.asarray(im.convert("L"))
    return _keep(key, arr, "pil")


def decode_gray_batch(paths: List[str], n_threads: int = 4
                      ) -> List[np.ndarray]:
    """Batch decode: cached files from the cache, the rest in one native
    thread-pooled call; a file the reader refuses goes to Pillow alone.
    Result order matches ``paths``."""
    keys = [_key(p) for p in paths]
    out: List = [_DECODE_CACHE.get(k) for k in keys]
    miss = [i for i, a in enumerate(out) if a is None]
    if miss:
        decoded = native_decode_batch([paths[i] for i in miss],
                                      n_threads=n_threads)
        for i, arr in zip(miss, decoded):
            out[i] = (_keep(keys[i], arr, "native") if arr is not None
                      else _decode_gray_pil(paths[i], keys[i]))
    return out


def _tiff_bytes(arr: np.ndarray) -> bytes:
    """A baseline little-endian TIFF: 8-bit, one sample, BlackIsZero,
    uncompressed, one strip."""
    h, w = arr.shape
    pixels = arr.tobytes()
    n_tags = 12
    res_off = 8 + 2 + 12 * n_tags + 4     # after the header and the IFD
    data_off = res_off + 16               # after two RATIONALs
    # (tag, type, value) in ascending tag order; type 3 SHORT (value in
    # the first two bytes of its field), 4 LONG, 5 RATIONAL (an offset)
    tags = ((256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1),
            (262, 3, 1), (273, 4, data_off), (277, 3, 1), (278, 4, h),
            (279, 4, len(pixels)), (282, 5, res_off),
            (283, 5, res_off + 8), (296, 3, 2))
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", n_tags)]
    for tag, typ, val in tags:
        out.append(struct.pack("<HHIHH", tag, typ, 1, val, 0) if typ == 3
                   else struct.pack("<HHII", tag, typ, 1, val))
    out.append(struct.pack("<I", 0))                  # no next IFD
    out.append(struct.pack("<IIII", 72, 1, 72, 1))    # 72 per inch, x, y
    out.append(pixels)
    return b"".join(out)


def write_tiff(path: str, arr: np.ndarray) -> bool:
    """Write a uint8 grayscale (H, W) array as a baseline uncompressed
    TIFF, with numpy alone. Returns True (``segtpu``'s signature);
    raises on a bad array or a failed write."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"write_tiff: want a 2-D array, got {arr.shape}")
    with open(path, "wb") as f:
        f.write(_tiff_bytes(arr))
    return True


def clear_decode_cache() -> None:
    with _LOCK:
        _DECODE_CACHE.clear()


def make_synthetic_dataset(root: str, n_images: int = 12,
                           image_type: str = "W",
                           raw_size: Tuple[int, int] = (160, 192),
                           seed: int = 0) -> str:
    """A synthetic cell-microscopy dataset under the reference's naming
    contract (``*_GT.tif`` masks, modality char at ``parts[3][1]``;
    dataset.py:92-111): bright blobs on a noisy background, masks the
    blob supports. The same files, pixel for pixel, as ``segtpu``'s for
    the same arguments. Returns ``root`` (a ``data_dir``)."""
    rng = np.random.default_rng(seed)
    images_dir = os.path.join(root, "Labelled_images")
    masks_dir = os.path.join(root, "GT_masks")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(masks_dir, exist_ok=True)

    h, w = raw_size
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n_images):
        img = rng.normal(70, 12, (h, w))
        mask = np.zeros((h, w), bool)
        for _ in range(rng.integers(2, 6)):
            cy, cx = rng.integers(10, h - 10), rng.integers(10, w - 10)
            ry, rx = rng.integers(6, 18), rng.integers(6, 18)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            img[blob] += rng.uniform(60, 120)
            mask |= blob
        img = np.clip(img, 0, 255).astype(np.uint8)
        # Name shape: Img_A_B_1W_<i>.tif → parts[3][1] == 'W'
        stem = f"Img_A_B_1{image_type}_{i:03d}"
        write_tiff(os.path.join(images_dir, f"{stem}.tif"), img)
        write_tiff(os.path.join(masks_dir, f"{stem}_GT.tif"),
                   mask.astype(np.uint8) * 255)
    return root
