"""Build and load the hand-written CUDA kernels of ``segtpu_torch/csrc``,
and give their ``torch.library`` ops a gradient.

Each ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc`` into
``build/segtpu_torch/lib<name>.so`` at the root of the checkout (all
sources start together), for ``sm_90a``, with a plain C interface that the
wrappers call through ``ctypes``. A library is rebuilt when it is older
than its source or a shared header. Nothing is built or loaded at import.

Launch counts: a wrapper calls ``count_launch`` where it launches its
kernel. A launch on a stream that is capturing a CUDA graph is recorded,
not run: it is tallied for the graph being captured through
``CountedGraph.capture``, and each ``CountedGraph.replay`` adds that
tally to the wrappers' counts, so the counts include replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

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


def register_plain_autograd(op, plain) -> None:
    """Give the custom op ``op`` the gradient of its plain version
    ``plain``: the backward recomputes ``plain`` on the saved inputs and
    differentiates it (the Pallas kernels have no backward either; the
    models run the kernels only in eval mode, where a forward with grad
    enabled still has to reach its inputs' gradients)."""

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    def backward(ctx, grad):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = plain(*ins)
        wrt = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad))
        return tuple(next(grads) if t.requires_grad else None for t in ins)

    op.register_autograd(backward, setup_context=setup_context)


# the launch tally of the graph that ``CountedGraph.capture`` is capturing
_TALLY: Optional[dict] = None


def stream_capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False on a
    host without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: at once, or, while the
    stream captures a graph, in that graph's tally. A capture outside
    ``CountedGraph.capture`` raises: its replays could not be counted."""
    if not stream_capturing():
        wrapper.launches += 1
    elif _TALLY is None:
        raise RuntimeError(
            f"segtpu_torch kernel {wrapper.__name__} launched into a CUDA "
            "graph captured outside segtpu_torch.kernels.CountedGraph, "
            "whose replays its launch count cannot see")
    else:
        _TALLY[wrapper] = _TALLY.get(wrapper, 0) + 1


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the port's kernel
    launches it captured: ``tally`` maps each wrapper to its launches per
    replay."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.tally: Dict = {}

    @contextlib.contextmanager
    def capture(self, pool=None):
        """``torch.cuda.graph(self.graph, pool=pool)``, tallying the port's
        kernel launches made inside it."""
        global _TALLY
        outer, _TALLY = _TALLY, self.tally
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                yield self
        finally:
            _TALLY = outer

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n
