"""segtpu_torch — the PyTorch/CUDA port of ``segtpu`` for NVIDIA Hopper.

The JAX package ``segtpu`` stays the reference; this package mirrors its
module layout one module for one module, in PyTorch idiom. Every entry
point takes ``device`` and defaults to ``"cuda"``; on a host without CUDA
it raises unless the caller passes ``device="cpu"`` explicitly. Model
tensors are NCHW in shape and ``channels_last`` in memory; the kernels in
``segtpu_torch.kernels`` take their NHWC views.

This package imports ``torch`` and ``numpy`` only: never ``jax``, ``flax``
or anything of ``segtpu``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for
    (the default) and the host has none: the port never falls back to the
    CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segtpu_torch: CUDA is not available on this host; pass "
            "device='cpu' to run on the CPU")
    return dev
