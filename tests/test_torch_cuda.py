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


def _gate_close(cuda, shape, dtype, seed):
    b, h, w, cg, cx, f = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = [r(b, h, w, cg).to(dtype), r(b, h, w, cx).to(dtype),
            (r(cg, f) / cg ** 0.5).to(dtype), (r(cx, f) / cx ** 0.5).to(dtype),
            r(f) * 0.1, (r(f) / f ** 0.5).to(dtype),
            torch.full((1,), 0.1, device=cuda)]
    before = attention_gate.launches
    out = attention_gate(*args)
    assert attention_gate.launches == before + 1
    _close(out, attention_gate_plain(*[t.float() for t in args]), dtype)


# (B, H, W, Cg, Cx, F) at the edges of the bf16 tensor-core gate (64 pixel
# rows per block, 32-channel ring chunks, passes of 32, 64 or 128 hidden
# columns): M = 1, 15, 17, 65 and 68 pixels (a block barely used, or one
# row into the next); Cg or Cx = 5 (rows not 16-byte aligned: plain-load
# staging, element-wise stores), 24 (below one chunk) and 40 (a
# half-empty tail chunk); F = 8 and 24 (a partial 32-column pass), 40 (a
# partial 64-column pass), 136 (a full 128-column pass and an 8-column
# one).
GATE_EDGE_SHAPES = [(1, 1, 1, 24, 40, 8), (1, 3, 5, 5, 24, 24),
                    (1, 1, 17, 40, 5, 136), (1, 5, 13, 24, 24, 136),
                    (1, 4, 17, 5, 5, 8), (2, 7, 9, 40, 40, 40)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", GATE_EDGE_SHAPES,
                         ids=["-".join(map(str, s)) for s in GATE_EDGE_SHAPES])
def test_gate_kernel_at_tile_edges(cuda, shape, dtype):
    _gate_close(cuda, shape, dtype, seed=5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gate_kernel_at_resnet50_widths(cuda, dtype):
    """resnet50's widest gate, (Cg, Cx, F) = (1024, 1024, 512): x's rows
    of 1024 channels beside the ring, four 128-column passes over F."""
    _gate_close(cuda, (1, 3, 7, 1024, 1024, 512), dtype, seed=6)


def test_gate_kernel_past_the_tensor_core_widths(cuda):
    """A bf16 gate whose x rows do not fit beside the ring (Cx = 1600,
    past the 1504 the ``.cu`` note gives) takes the CUDA-core kernel and
    is still right."""
    _gate_close(cuda, (1, 2, 5, 64, 1600, 128), torch.bfloat16, seed=7)


def _upsample_close(cuda, shape, dtype, seed):
    b, h, w, cin, co, cs = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = [r(b, h, w, cin).to(dtype),
            (r(cin, 2, 2, co) / cin ** 0.5).to(dtype), r(co) * 0.1,
            r(b, 2 * h, 2 * w, cs).to(dtype)]
    before = upsample2x_concat.launches
    out = upsample2x_concat(*args)
    assert upsample2x_concat.launches == before + 1
    ref = upsample2x_concat_plain(*[t.float() for t in args])
    _close(out, ref, dtype)
    # the skip is copied bit for bit
    assert torch.equal(out[..., :cs], args[3])


# (B, H, W, Cin, Co, Cs) at the edges of the bf16 tensor-core upsample (64
# input pixels of the flat M and 256 of the 4·Co columns per block,
# 32-channel ring chunks): W = 1, 3 and 33 (blocks that span image rows);
# Cin = 20 (plain-load staging of x, a partial chunk); Co = 12 (4·Co = 48,
# runs that cross taps: element-wise stores), 72 and 136 (two and three
# column blocks, the last partial); Cs = 7 (element-wise skip copy) and 64.
UPSAMPLE_EDGE_SHAPES = [(1, 2, 1, 20, 12, 7), (2, 3, 3, 20, 72, 64),
                        (1, 2, 33, 20, 136, 7), (1, 3, 33, 24, 136, 64),
                        (1, 5, 3, 16, 12, 64), (3, 3, 33, 20, 72, 7)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", UPSAMPLE_EDGE_SHAPES,
                         ids=["-".join(map(str, s))
                              for s in UPSAMPLE_EDGE_SHAPES])
def test_upsample_kernel_at_tile_edges(cuda, shape, dtype):
    _upsample_close(cuda, shape, dtype, seed=8)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_upsample_kernel_at_resnet50_widths(cuda, dtype):
    """resnet50's level-4 upconv, Cin 2048 -> Co 1024 beside a skip of
    1024: 64 ring chunks over Cin, 16 column blocks."""
    _upsample_close(cuda, (1, 2, 3, 2048, 1024, 1024), dtype, seed=9)


# The gate's (Cg, Cx, F) and the fused upsample's (Cin, Co, Cs) at the
# levels resnet50's and densenet121's U-Nets give them (levels 4..1 and
# 3..1 at B=16, 512²; segtpu_torch/models/unet.py's decoder plan):
# densenet121 has Cx = 2·Cg and Cs = 2·Co. Ragged: B=2 at 5×7 pixels.
ENCODER_GATES = {"resnet50": [(1024, 1024, 512), (512, 512, 256),
                              (256, 256, 128), (64, 64, 32)],
                 "densenet121": [(512, 1024, 256), (256, 512, 128),
                                 (128, 256, 64), (64, 64, 32)]}
ENCODER_UPSAMPLES = {"resnet50": [(1024, 512, 512), (512, 256, 256),
                                  (256, 64, 64)],
                     "densenet121": [(512, 256, 512), (256, 128, 256),
                                     (128, 64, 64)]}
GATE_WIDTHS = [(b, w) for b, ws in ENCODER_GATES.items() for w in ws]
UPSAMPLE_WIDTHS = [(b, w) for b, ws in ENCODER_UPSAMPLES.items() for w in ws]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("backbone,widths", GATE_WIDTHS,
                         ids=[f"{b}-" + "-".join(map(str, w))
                              for b, w in GATE_WIDTHS])
def test_gate_kernel_at_encoder_widths(cuda, backbone, widths, dtype):
    _gate_close(cuda, (2, 5, 7, *widths), dtype, seed=10)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("backbone,widths", UPSAMPLE_WIDTHS,
                         ids=[f"{b}-" + "-".join(map(str, w))
                              for b, w in UPSAMPLE_WIDTHS])
def test_upsample_kernel_at_encoder_widths(cuda, backbone, widths, dtype):
    _upsample_close(cuda, (2, 5, 7, *widths), dtype, seed=11)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gate_and_upsample_at_ragged_shapes(cuda, dtype):
    # M = 15 pixels, Cg 8, Cx 12, F 8; then Cs != Co and 4·Co = 48, not a
    # multiple of the f32 kernel's 64-column tile
    _gate_close(cuda, (1, 3, 5, 8, 12, 8), dtype, seed=3)
    _upsample_close(cuda, (2, 3, 5, 20, 12, 7), dtype, seed=3)


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


# ------------------------------------------------- data layer on the card

# (raw, out): ragged raw frames down to 64², an upscale, a mixed scale,
# and the flagship's 1040×1392 → 512².
RESIZE_SHAPES = [((97, 131), (64, 64)), ((31, 45), (64, 64)),
                 ((130, 50), (64, 64)), ((1040, 1392), (512, 512))]


@pytest.mark.parametrize("raw,out", RESIZE_SHAPES,
                         ids=["ragged", "up", "mixed", "flagship"])
def test_resize_on_the_card_matches_the_cpu(cuda, raw, out):
    """Full float32 on both (TF32 off): within 1e-4 on the 0–255 scale;
    after rounding within one level at no more than 0.1% of pixels."""
    from segtpu_torch.data.preprocess import _round_u8
    from segtpu_torch.ops.resize import resize_area, resize_nearest
    gen = torch.Generator().manual_seed(raw[0])
    imgs = torch.randint(0, 256, (3, *raw), generator=gen,
                         dtype=torch.uint8)
    got, want = resize_area(imgs.to(cuda), out).cpu(), resize_area(imgs, out)
    assert got.shape == want.shape == (3, *out)
    assert (got - want).abs().max().item() <= 1e-4
    diff = (_round_u8(got).int() - _round_u8(want).int()).abs()
    assert diff.max().item() <= 1 and diff.bool().float().mean() <= 1e-3
    assert torch.equal(resize_nearest(imgs.to(cuda), out).cpu(),
                       resize_nearest(imgs, out))


def test_resize_area_ignores_a_caller_s_tf32(cuda):
    """A caller who turns TF32 on gets the same full-float32 resize, and
    gets the flag back as it was."""
    from segtpu_torch.ops.resize import resize_area
    gen = torch.Generator().manual_seed(1)
    imgs = torch.randint(0, 256, (2, 1040, 1392), generator=gen,
                         dtype=torch.uint8).to(cuda)
    want = resize_area(imgs, (512, 512))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = resize_area(imgs, (512, 512))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, want)
    assert (got.cpu() - resize_area(imgs.cpu(), (512, 512))).abs().max() \
        <= 1e-4


@pytest.mark.parametrize("name", ["t_random_rotate_90", "t_affine",
                                  "t_vertical_flip", "t_advanced_blur"])
def test_production_transform_on_the_card_matches_the_cpu(cuda, name):
    """The production transforms' apply on 97² frames, the same draws on
    both: images within one level, masks equal at all but 0.1% of pixels
    (a coordinate an ulp from a half-pixel can round either way); the
    relayouts move the mask exactly as the image."""
    from segtpu_torch.data import augment
    t = getattr(augment, name)
    gen = torch.Generator().manual_seed(0)
    s = 97
    img = torch.rand(4, s, s, generator=gen) * 255
    mask = (torch.rand(4, s, s, generator=gen) > 0.7).float() * 255
    params = t.draw(gen, 4, s)
    wi, wm = t.apply(img, mask, params)
    gi, gm = t.apply(img.to(cuda), mask.to(cuda),
                     {k: v.to(cuda) for k, v in params.items()})
    gi, gm = gi.cpu(), gm.cpu()
    assert (torch.floor(gi + 0.5) - torch.floor(wi + 0.5)).abs().max() <= 1
    assert (gm != wm).float().mean().item() <= 1e-3
    if name in ("t_random_rotate_90", "t_vertical_flip"):
        same, moved = t.apply(mask.to(cuda), mask.to(cuda),
                              {k: v.to(cuda) for k, v in params.items()})
        assert torch.equal(same, moved)
