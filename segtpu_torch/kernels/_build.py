"""Build and load the hand-written CUDA kernels of ``segtpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc`` into
``build/segtpu_torch/lib<name>.so`` at the root of the checkout (all
sources start together), for ``sm_90a``, with a plain C interface that the
wrappers call through ``ctypes``. A library is rebuilt when it is older
than its source or a shared header. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "segtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# element-type codes of the C entries (segtpu::DType in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("segtpu_torch: nvcc not found (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(src: Path) -> bool:
    out = lib_path(src.stem)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return out.stat().st_mtime < newest


def build() -> Dict[str, dict]:
    """Compile every stale source, one ``nvcc`` per source, all at once.
    Returns {name: {"seconds": wall time, "log": compiler output}} for the
    sources it compiled; raises with the compiler output on a failure."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [s for s in sources if _stale(s)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = BUILD_DIR / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src.stem, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    done, failed = {}, []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib_path(name))
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("segtpu_torch kernel build failed\n"
                           + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(lib_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launcher(name: str, argtypes):
    """The entry ``<name>_launch`` of ``csrc/<name>.cu`` (built and loaded
    at first use) with its C argument types declared; it returns the CUDA
    error code of the launch."""
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch entry returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"segtpu_torch kernel {name}: CUDA error {code} "
                           f"({msg})")
