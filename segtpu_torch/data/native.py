"""ctypes bindings for the port's native TIFF reader
(``segtpu_torch/native/segtpu_io.cc``; port of ``segtpu/data/native.py``).

The library is built at first use with g++ into
``build/segtpu_torch/libsegtpu_io.so`` at the root of the checkout, and
rebuilt when it is older than its source. A failed build raises with
g++'s output: the port never turns it silently into another decoder. A
file the reader does not support (another TIFF variant, not a TIFF) gives
``None``, and the caller decides what to do with it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from segtpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "segtpu_io.cc"
LIBRARY = BUILD_DIR / "libsegtpu_io.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build() -> Path:
    """Compile the reader if its library is missing or older than the
    source; returns the library's path. Raises with g++'s output on a
    failure."""
    if LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of its own per process, then one atomic rename: processes
    # that build at once never load a half-written file
    tmp = BUILD_DIR / f"libsegtpu_io.{os.getpid()}.tmp.so"
    cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"segtpu_torch: cannot build the TIFF reader: "
                           f"{cmd[0]} not found") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"segtpu_torch: building the TIFF reader failed (exit "
            f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.segtpu_probe_gray.restype = ctypes.c_int
            lib.segtpu_probe_gray.argtypes = [ctypes.c_char_p, i32p, i32p]
            lib.segtpu_decode_gray.restype = ctypes.c_int
            lib.segtpu_decode_gray.argtypes = [
                ctypes.c_char_p, u8p, ctypes.c_int64, i32p, i32p]
            lib.segtpu_decode_batch_at.restype = None
            lib.segtpu_decode_batch_at.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, u8p, i64p,
                i64p, i32p, i32p, ctypes.c_int32]
            _LIB = lib
    return _LIB


def native_probe(path: str) -> Optional[Tuple[int, int]]:
    """Header-only probe: (H, W) if the file is a supported TIFF."""
    lib = _load()
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    if lib.segtpu_probe_gray(os.fsencode(path), ctypes.byref(w),
                             ctypes.byref(h)) != 0:
        return None
    return int(h.value), int(w.value)


def native_decode_gray(path: str) -> Optional[np.ndarray]:
    """One grayscale TIFF as uint8 (H, W); None if unsupported."""
    probe = native_probe(path)
    if probe is None:
        return None
    hh, ww = probe
    buf = np.empty(hh * ww, np.uint8)
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = _load().segtpu_decode_gray(
        os.fsencode(path), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        hh * ww, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value)


# Output-buffer budget of one batch call. Header dimensions come from the
# files (up to 512 MPixel per image), so batches whose probed total
# exceeds this are decoded in budget-sized chunks.
BATCH_BUDGET_BYTES = 1 << 30


def native_decode_batch(paths: List[str], n_threads: int = 4
                        ) -> List[Optional[np.ndarray]]:
    """Thread-pooled batch decode; None for each unsupported file.

    Header probes size every image, then one exact-sized allocation is
    filled by the reader's thread pool (the GIL is released meanwhile),
    in chunks of at most ``BATCH_BUDGET_BYTES``."""
    n = len(paths)
    if n == 0:
        return []
    lib = _load()
    shapes = [native_probe(p) for p in paths]
    sizes = [s[0] * s[1] if s is not None else 0 for s in shapes]
    if sum(sizes) > BATCH_BUDGET_BYTES and n > 1:
        results: List[Optional[np.ndarray]] = []
        start, acc = 0, 0
        for i, sz in enumerate(sizes):
            if acc and acc + sz > BATCH_BUDGET_BYTES:
                results.extend(native_decode_batch(paths[start:i], n_threads))
                start, acc = i, 0
            acc += sz
        results.extend(native_decode_batch(paths[start:], n_threads))
        return results
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    out = np.empty(max(sum(sizes), 1), np.uint8)
    caps = np.asarray(sizes, np.int64)
    dims = np.zeros(2 * n, np.int32)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.segtpu_decode_batch_at(
        names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    results = []
    for i in range(n):
        if shapes[i] is None or status[i] != 0:
            results.append(None)
            continue
        hh, ww = int(dims[2 * i]), int(dims[2 * i + 1])
        start = int(offsets[i])
        results.append(out[start: start + hh * ww].reshape(hh, ww).copy())
    return results
