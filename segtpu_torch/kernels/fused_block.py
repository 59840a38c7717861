"""The fused decoder block at inference, ``[conv3×3 · scale + bias →
ReLU] ×2`` with the intermediate kept on chip: wrapper, plain version and
launch count of ``csrc/conv_pair_bn_relu.cu``.

Replaces ``segtpu/kernels/fused_block.py::conv_pair_bn_relu_pallas``. The
source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it. No model path runs it: the JAX package
reaches it only from its fused-block bench, whose counterpart is
``segtpu_torch.tools.fused_block_bench``.
"""

from __future__ import annotations

import ctypes

import torch

from segtpu_torch.kernels import _build
from segtpu_torch.kernels._build import DTYPE_CODES
from segtpu_torch.kernels.fused_conv import (check_conv_chain,
                                             conv3x3_bn_relu_plain)

# Shared memory a block of the kernel may have on Hopper (opt-in maximum);
# ``kSmemLimit`` in the ``.cu`` file.
SMEM_LIMIT = 232448
# The bf16 tiles of ``csrc/conv_pair_bn_relu.cu`` (``NarrowTile``,
# ``BigTile``, ``RectTile``, ``SmallTile``) in the order the launcher tries
# them: (tile rows TH, tile columns TW, output channels per chunk NC,
# reduction channels per stage KC, pipeline stages, wgmma or mma.sync).
# The first is taken only for C <= its NC, the last whether it fits or
# not.
BF16_TILES = ((16, 16, 32, 16, 3, False), (16, 16, 64, 16, 3, True),
              (8, 16, 128, 16, 3, True), (8, 8, 32, 16, 2, False))
# The f32 kernel's output tile (``kT`` x ``kT``).
F32_TILE = (8, 8)


def _bf16_smem_bytes(tile, c: int) -> int:
    """``PairTile::smem_bytes`` / ``PairWgTile::smem_bytes``: the ring of
    cp.async stages, each the (TH+4) x (TW+4) input window and the 9 taps
    of KC x NC weights (a wgmma stage rounded up to 1024 bytes, and 1024
    more to align the ring), and the (TH+2) x (TW+2) intermediate rows of
    Cp + 8 channels (Cp = C rounded up to 16), all bf16."""
    th, tw, nc, kc, stages, wgmma = tile
    stage = 2 * ((th + 4) * (tw + 4) * kc + 9 * kc * nc)
    if wgmma:
        stage = -(-stage // 1024) * 1024
    cp = -(-c // 16) * 16
    return (stages * stage + 1024 * wgmma
            + 2 * (th + 2) * (tw + 2) * (cp + 8))


def _bf16_tile(c: int):
    """The bf16 tile the launcher takes for C channels."""
    narrow, *rest = BF16_TILES
    if c <= narrow[2]:
        return narrow
    return next((t for t in rest if _bf16_smem_bytes(t, c) <= SMEM_LIMIT),
                rest[-1])


def pair_tile(c: int, dtype) -> tuple:
    """The (rows, columns) of the output tile the kernel uses for C
    channels of ``dtype``."""
    return _bf16_tile(c)[:2] if dtype == torch.bfloat16 else F32_TILE


def smem_bytes(c: int, dtype) -> int:
    """Shared bytes one block of the kernel needs for C channels of
    ``dtype``. bf16: ``_bf16_smem_bytes`` of ``_bf16_tile``. f32: the f32
    input window (12² pixels × 17) and weight chunk (9 × 16 × NC, NC = 32
    for C <= 32 else 64), and the intermediate (10² pixels × (C + 1)).
    Mirrors ``PairTile::smem_bytes`` and ``smem_bytes`` in
    ``csrc/conv_pair_bn_relu.cu``."""
    if dtype == torch.bfloat16:
        return _bf16_smem_bytes(_bf16_tile(c), c)
    nc = 32 if c <= 32 else 64
    return 4 * (12 * 12 * 17 + 9 * 16 * nc) + 100 * (c + 1) * 4


def conv_pair_bn_relu_plain(x, w1, s1, b1, w2, s2, b2):
    """The block as two ``conv3x3_bn_relu_plain`` calls. The intermediate
    is rounded to x's dtype before conv 2, as ``conv_pair_bn_relu_xla``
    does."""
    return conv3x3_bn_relu_plain(conv3x3_bn_relu_plain(x, w1, s1, b1),
                                 w2, s2, b2)


# C signature of conv_pair_bn_relu_launch: dtype, x, w1, s1, b1, w2, s2,
# b2, out, batch, h, w, cin, c, stream
ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 8
            + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def conv_pair_bn_relu(x, w1, s1, b1, w2, s2, b2, *, tile: int = 32):
    """Fused ``relu(conv3x3(relu(conv3x3(x, w1)·s1 + b1), w2)·s2 + b2)``,
    one kernel launch; the intermediate never leaves the chip.

    x (B,H,W,Cin) NHWC-contiguous; w1 (3,3,Cin,C) and w2 (3,3,C,C) HWIO
    in x's dtype (float32 or bfloat16); s1, b1, s2, b2 (C,) float32.
    Returns (B,H,W,C) in x's dtype. ``tile`` is the JAX kernel's spatial
    tile, kept so the two signatures match; this kernel picks its own
    output tile so that the haloed intermediate fits in shared memory
    (``pair_tile``): in bf16, 16×16 up to C = 192, 8×16 up to 256 and 8×8
    above, both convs as bf16 tensor-core products (``wgmma`` at 16×16
    above C = 32 and at 8×16, else ``mma.sync``), bounded on the card by
    the products' issue rate and conv 1's halo recompute (1.27× at
    16×16, 1.41× at 8×16); in f32, 8×8 on the CUDA cores. It masks its own
    ragged edge. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (and counts the launch) or raises.
    """
    check_conv_chain("conv_pair_bn_relu", x,
                     [(("w1", w1), ("s1", s1), ("b1", b1)),
                      (("w2", w2), ("s2", s2), ("b2", b2))])
    c = w1.shape[-1]
    if smem_bytes(c, x.dtype) > SMEM_LIMIT:
        raise ValueError(f"conv_pair_bn_relu: C={c} in {x.dtype} needs "
                         f"{smem_bytes(c, x.dtype)} bytes of shared memory "
                         f"per block, more than {SMEM_LIMIT}")
    if x.device.type == "cpu":
        return conv_pair_bn_relu_plain(x, w1, s1, b1, w2, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pair_bn_relu: unsupported device {x.device}")
    bsz, h, wd, cin = x.shape
    out = torch.empty((bsz, h, wd, c), dtype=x.dtype, device=x.device)
    fn = _build.launcher("conv_pair_bn_relu", ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
                  s1.data_ptr(), b1.data_ptr(), w2.data_ptr(), s2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), bsz, h, wd, cin, c, stream)
    _build.check("conv_pair_bn_relu", code)
    conv_pair_bn_relu.launches += 1
    return out


conv_pair_bn_relu.launches = 0
