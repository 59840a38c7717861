"""The port's CUDA kernels against their plain versions on the card, at
small, ragged and odd-width shapes that the flagship never gives them:
H and W not multiples of any tile, channel counts that leave partial
chunks, several output-channel tiles. ``chip_smoke.py`` covers the
flagship shapes.

Needs an NVIDIA card; every test skips without one. This file imports no
JAX, so it runs on the card without the JAX test setup:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are those of ``chip_smoke.py``, whose header gives the
reasons: f32 within 1e-4, bf16 within 2^-7 of the output's scale
(at least 1).
"""

import pytest
import torch

from segtpu_torch.kernels import launch_counts
from segtpu_torch.kernels.attention_gate import (attention_gate,
                                                 attention_gate_plain)
from segtpu_torch.kernels.fused_block import (conv_pair_bn_relu, smem_bytes,
                                              SMEM_LIMIT)
from segtpu_torch.kernels.fused_conv import (conv3x3_bn_relu,
                                             conv3x3_bn_relu_plain,
                                             upsample2x_concat,
                                             upsample2x_concat_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref).abs().max().item()
    tol = TOL[dtype] * max(1.0, ref.abs().max().item())
    assert err <= tol, f"max_abs_err {err:.3g} > tol {tol:.3g}"


def _conv_params(gen, dev, dtype, cin, cout):
    w = torch.randn(3, 3, cin, cout, generator=gen, device=dev)
    return [(w / (3 * cin ** 0.5)).to(dtype),
            0.5 + torch.rand(cout, generator=gen, device=dev),
            0.1 * torch.randn(cout, generator=gen, device=dev)]


# (B, H, W, Cin, Cout): ragged H/W with Cin < one chunk and Cout <= 32 (the
# narrow tile); two and a half 64-channel tiles; an even case. Then the
# bf16 tiles' edges (16x16 pixels x 32 channels on mma.sync, 16 input
# channels per stage; 16x32 x 64 on wgmma, 32 per stage): H and W that
# leave partial tiles in both directions; Cin = 8, 16, 24, so the pipeline
# is deeper than the K loop; Cin = 5 (rows not 16-byte aligned: plain-load staging) and 40 (a
# half-empty tail chunk); Cout = 72, 136 (partial column blocks) and 33
# (plain-load weights, element-wise stores).
CONV_SHAPES = [(2, 13, 19, 5, 24), (1, 9, 70, 40, 136), (3, 8, 8, 64, 64),
               (2, 21, 37, 16, 72), (1, 19, 23, 8, 136), (2, 17, 33, 24, 32),
               (1, 13, 19, 5, 64), (1, 11, 12, 40, 33)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["-".join(map(str, s)) for s in CONV_SHAPES])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda).to(dtype)
    args = [x] + _conv_params(gen, cuda, dtype, cin, cout)
    before = conv3x3_bn_relu.launches
    out = conv3x3_bn_relu(*args)
    assert conv3x3_bn_relu.launches == before + 1
    _close(out, conv3x3_bn_relu_plain(*[t.float() for t in args]), dtype)


# (B, H, W, Cin, C): ragged H/W, C not a multiple of the 16-channel chunk
# and <= 32; C between 32 and 64; C over one 64-channel tile; a tile-sized
# image with a wide input. Then the bf16 tiles' edges (16x16 output tiles
# with 32-channel chunks up to C = 32 on mma.sync and 64-channel chunks up
# to 192 on wgmma, 8x16 with 128-channel chunks up to 256 on wgmma, 8x8
# with 32-channel chunks above on mma.sync): partial tiles in both
# directions with Cin = 8; C = 72 and 136 (a partial last chunk) with
# Cin = 24; C = 192, the widest 16x16 tile; C = 200 (a partial chunk)
# with Cin = 40 (a half-empty tail chunk) and 256, both 8x16; C = 416,
# the 8x8 tile; C = 20 and Cin = 12 (plain-load staging, element-wise
# stores); C = 33, 193 and 257, the first width of each tile after the
# first.
PAIR_SHAPES = [(2, 13, 19, 5, 24), (1, 17, 9, 40, 48), (1, 8, 16, 16, 80),
               (2, 8, 8, 160, 32), (1, 21, 35, 8, 72), (2, 19, 17, 24, 136),
               (1, 18, 20, 16, 192), (1, 12, 20, 40, 200),
               (1, 13, 37, 16, 256), (1, 10, 11, 8, 416),
               (1, 11, 10, 12, 20), (1, 9, 17, 16, 33), (1, 10, 19, 8, 193),
               (1, 9, 18, 16, 257)]


def _pair_close(cuda, shape, dtype, seed):
    b, h, w, cin, c = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda).to(dtype)
    first = _conv_params(gen, cuda, dtype, cin, c)
    second = _conv_params(gen, cuda, dtype, c, c)
    before = conv_pair_bn_relu.launches
    out = conv_pair_bn_relu(x, *first, *second)
    assert conv_pair_bn_relu.launches == before + 1
    # the intermediate rounded to the I/O type, conv 2 and result in f32
    mid = conv3x3_bn_relu_plain(x, *first).float()
    _close(out, conv3x3_bn_relu_plain(mid, *[t.float() for t in second]),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PAIR_SHAPES,
                         ids=["-".join(map(str, s)) for s in PAIR_SHAPES])
def test_conv_pair_kernel_matches_plain(cuda, shape, dtype):
    _pair_close(cuda, shape, dtype, seed=2)


def test_conv_pair_bf16_at_the_widest_width_it_takes(cuda):
    """C = 928, the widest bf16 pair the kernel took before its
    tensor-core redesign, on the 8x8 tile (f32 refuses it)."""
    assert smem_bytes(928, torch.bfloat16) <= SMEM_LIMIT
    _pair_close(cuda, (1, 9, 10, 16, 928), torch.bfloat16, seed=4)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gate_and_upsample_at_ragged_shapes(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    g, x = r(1, 3, 5, 8).to(dtype), r(1, 3, 5, 12).to(dtype)
    gate = [g, x, (r(8, 8) / 3).to(dtype), (r(12, 8) / 3).to(dtype),
            r(8) * 0.1, (r(8) / 3).to(dtype), torch.full((1,), 0.1,
                                                         device=cuda)]
    _close(attention_gate(*gate),
           attention_gate_plain(*[t.float() for t in gate]), dtype)
    # Cs != Co and Co not a multiple of the 64-column tile
    ups = [r(2, 3, 5, 20).to(dtype), (r(20, 2, 2, 12) / 5).to(dtype),
           r(12) * 0.1, r(2, 6, 10, 7).to(dtype)]
    _close(upsample2x_concat(*ups),
           upsample2x_concat_plain(*[t.float() for t in ups]), dtype)


def test_cuda_wrappers_refuse_before_launching(cuda):
    before = launch_counts()
    x = torch.zeros(1, 8, 8, 16, device=cuda)
    w, s, b = (torch.zeros(3, 3, 16, 16, device=cuda),
               torch.ones(16, device=cuda), torch.zeros(16, device=cuda))
    with pytest.raises(TypeError):
        conv3x3_bn_relu(x.half(), w.half(), s, b)
    c = 512
    assert smem_bytes(c, torch.float32) > SMEM_LIMIT
    wide = [torch.zeros(3, 3, 16, c, device=cuda), torch.ones(c, device=cuda),
            torch.zeros(c, device=cuda), torch.zeros(3, 3, c, c, device=cuda),
            torch.ones(c, device=cuda), torch.zeros(c, device=cuda)]
    with pytest.raises(ValueError, match="shared memory"):
        conv_pair_bn_relu(x, *wide)
    assert launch_counts() == before
