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


def test_stream_window_fetches_once_and_syncs_nowhere_else(cuda):
    """One ``stream`` window of two tiny folds (resnet_tiny with attention,
    64², 2 epochs each, the gate kernel in every validation pass) under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the
    window synchronises with the host, except its one device→host copy
    of the totals."""
    from segtpu_torch.eval import fold_parallel as fp
    from segtpu_torch.train.engine import get_engine

    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "bce"}, device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    arrays = [(torch.rand(5, 1, 64, 64, generator=gen, device=cuda),
               (torch.rand(5, 1, 64, 64, generator=gen, device=cuda) > 0.7)
               .float(),
               torch.rand(3, 1, 64, 64, generator=gen, device=cuda),
               (torch.rand(3, 1, 64, 64, generator=gen, device=cuda) > 0.7)
               .float()) for _ in range(2)]
    states = [engine.init_state(torch.Generator().manual_seed(s), 1e-3,
                                1e-5) for s in (0, 1000)]
    gens = [torch.Generator(cuda).manual_seed(s + 1) for s in (0, 1000)]
    live, lrs = [0, 1], [1e-3, 1e-3]

    def window(h):
        pending, snaps, _ = fp.dispatch_window(
            [engine] * 2, states, arrays, gens, live, h, lrs, 2)
        return fp._fetch([t for pj in pending for k in live
                          for t in pj[k]])

    window(1)     # first calls: the kernel's build, cuDNN's choices
    torch.cuda.synchronize()
    fp.reset_fetch_count()
    launched = launch_counts()["attention_gate"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        totals = window(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fp.fetch_count() == 1
    assert totals.device.type == "cpu" and totals.shape == (8, 6)
    assert torch.isfinite(totals).all()
    # 2 folds × 2 epochs × 2 validation batches (3 images at B=2) × 4 gates
    assert launch_counts()["attention_gate"] - launched == 32


# ------------------------------------- the ops, exported artifacts, TTA

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ops_through_torch_ops_at_ragged_shapes(cuda, dtype):
    """``torch.ops.segtpu_torch.*``, the entries an exported graph calls
    without the Python wrappers, launch the kernels (and count them) at
    B=1, 17² and odd widths, against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    g, x = r(1, 17, 17, 24).to(dtype), r(1, 17, 17, 40).to(dtype)
    gate = [g, x, (r(24, 8) / 24 ** 0.5).to(dtype),
            (r(40, 8) / 40 ** 0.5).to(dtype), r(8) * 0.1,
            (r(8) / 8 ** 0.5).to(dtype), torch.full((1,), 0.1, device=cuda)]
    ups = [r(1, 17, 17, 20).to(dtype), (r(20, 2, 2, 12) / 20 ** 0.5).to(
        dtype), r(12) * 0.1, r(1, 34, 34, 7).to(dtype)]
    before = launch_counts()
    out_g = torch.ops.segtpu_torch.attention_gate(*gate)
    out_u = torch.ops.segtpu_torch.upsample2x_concat(*ups)
    after = launch_counts()
    assert after["attention_gate"] == before["attention_gate"] + 1
    assert after["upsample2x_concat"] == before["upsample2x_concat"] + 1
    _close(out_g, attention_gate_plain(*[t.float() for t in gate]), dtype)
    _close(out_u, upsample2x_concat_plain(*[t.float() for t in ups]), dtype)
    # the CUDA implementation checks its operands itself: a strided view
    # is refused before any launch
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        torch.ops.segtpu_torch.attention_gate(
            g, x.transpose(1, 2), *gate[2:])
    assert launch_counts() == after


def test_fused_gate_backpropagates_on_the_card(cuda):
    """An eval-mode gate forward with grad enabled reaches its inputs'
    gradients through the op's registered backward (the plain version's
    gradient), equal to the unfused gate's."""
    from segtpu_torch.models.attention import AttentionGate
    torch.manual_seed(0)
    gate = AttentionGate(16, 24, 8, device=cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = torch.randn(2, 16, 5, 7, generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last)
    x = torch.randn(2, 24, 5, 7, generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last)
    grads = []
    for fused in (True, False):
        xr = x.clone().requires_grad_(True)
        gate(g, xr, fused=fused).square().sum().backward()
        grads.append(xr.grad)
    _close(grads[0], grads[1].float(), torch.float32)


def _tiny_model(cuda, use_attention, **kw):
    from segtpu_torch.models.unet import UNetWithBackbone
    model = UNetWithBackbone(backbone="resnet_tiny",
                             use_attention=use_attention, device=cuda, **kw)
    return model.reset_parameters(torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("use_attention", [True, False],
                         ids=["attention", "no-attention"])
def test_artifact_exported_on_the_card_launches_its_kernels(cuda, tmp_path,
                                                            use_attention):
    """An artifact exported and reloaded on the card launches 4 gates per
    forward (attention) or one upsample per frozen fused level (without),
    matches the live model, and loads and serves on the CPU too."""
    import numpy as np
    from segtpu_torch.infer.export import ServingModel, save_serving
    from segtpu_torch.infer.predict import predict_proba
    model = _tiny_model(cuda, use_attention, fuse_min_work=16)
    path = save_serving(str(tmp_path / "art"), model, (32, 32))
    sm = ServingModel(path, device="cuda")
    levels = sm.meta["fused_upsample_levels"]
    assert levels == ([] if use_attention else [2, 3, 4])
    x = np.random.default_rng(0).random((3, 32, 32, 1), np.float32)
    before = launch_counts()
    got = sm.predict_proba(x)
    after = launch_counts()
    assert after["attention_gate"] - before["attention_gate"] == (
        4 if use_attention else 0)
    assert after["upsample2x_concat"] - before["upsample2x_concat"] == len(
        levels)
    np.testing.assert_allclose(got, predict_proba(model, x, device="cuda"),
                               atol=1e-5)
    on_cpu = ServingModel(path, device="cpu").predict_proba(x)
    np.testing.assert_allclose(on_cpu, got, atol=1e-4)


def test_artifact_exported_on_the_cpu_launches_the_gate_on_the_card(
        cuda, tmp_path):
    import numpy as np
    from segtpu_torch.infer.export import ServingModel, save_serving
    model = _tiny_model(torch.device("cpu"), True)
    path = save_serving(str(tmp_path / "cpu"), model, (32, 32),
                        compute_dtype=torch.bfloat16)
    x = np.random.default_rng(1).random((2, 32, 32, 1), np.float32)
    want = ServingModel(path, device="cpu").predict_proba(x)
    before = launch_counts()["attention_gate"]
    got = ServingModel(path, device="cuda").predict_proba(x)
    assert launch_counts()["attention_gate"] - before == 4
    # the card's and the CPU's bf16 differ in rounding order only
    np.testing.assert_allclose(got, want, atol=2.0 ** -6)


def test_tta_batch_of_rotated_views_reaches_the_gate(cuda):
    """D4 TTA on the card: every rotated, transposed or flipped batch
    reaches the gate kernel (8 forwards × 4 launches) without the
    contiguity error, and equals the unfused gate's TTA."""
    import numpy as np
    from segtpu_torch.infer.tta import tta_predict_proba
    model = _tiny_model(cuda, True)
    x = np.random.default_rng(2).random((2, 32, 32, 1), np.float32)
    before = launch_counts()["attention_gate"]
    fused = tta_predict_proba(model, x, device="cuda")
    assert launch_counts()["attention_gate"] - before == 32
    model.fuse_gate = False
    plain = tta_predict_proba(model, x, device="cuda")
    np.testing.assert_allclose(fused, plain, atol=1e-4)


# ------------------------------------------ the fused training run (A18)

def _blob_arrays(n, size, seed):
    """n canonical uint8 images with bright blobs and their masks."""
    import numpy as np
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        cy, cx = r.integers(size // 4, 3 * size // 4, 2)
        masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < (size // 6) ** 2] = 1
    imgs = r.normal(60, 15, (n, size, size)) + 90.0 * masks
    return imgs.clip(0, 255).astype(np.uint8), masks


def _fit(cuda, fused, initial_state=None, **cfg):
    """train_model of resnet_tiny at 64² on 10 training images (B=4: two
    full batches and a remainder of 2) and 6 validation images (one full
    batch and a remainder of 2), f32; the plateau scheduler cuts the LR
    after every epoch."""
    from segtpu_torch.train.loop import train_model
    from segtpu_torch.train.optim import ReduceLROnPlateau
    imgs, masks = _blob_arrays(16, 64, 0)
    config = dict(backbone="resnet_tiny", use_attention=True,
                  img_size=(64, 64), batch_size=4, verbose=False,
                  loss_fn="combo", seed=0, fused_run=fused, **cfg)
    return train_model(None, imgs[:10], masks[:10], imgs[10:], masks[10:],
                       num_epochs=3, device=cuda, config=config,
                       scheduler=ReduceLROnPlateau(1e-3, patience=0,
                                                   threshold=0.5),
                       initial_state=initial_state)


@pytest.fixture
def deterministic(cuda):
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = flag


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd", "lamb"])
def test_fused_run_replays_every_optimizer_as_the_stepwise_loop(
        deterministic, optimizer):
    """Three epochs with LR cuts, fused against stepwise, in f32 with TF32
    off: the same LR history and per-epoch losses within 1e-4 relative
    (both loops step the same ``DeviceOptimizer``, so the runs agree to
    their last bits or nearly). An LR or a step count baked into the
    captured step would move the later epochs far past that."""
    step, fused = (_fit(deterministic, f, optimizer=optimizer)
                   for f in (False, True))
    assert fused["lr_history"] == step["lr_history"] == [1e-3, 5e-4, 2.5e-4]
    assert fused["best_epoch"] == step["best_epoch"]
    for key in ("train_metrics", "val_metrics"):
        for a, b in zip(fused[key], step[key]):
            assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), key


def test_fused_run_counts_replayed_launches_and_refolds_the_gates(cuda):
    """The validation graphs launch the gate kernel: 4 launches per
    replayed validation forward (and per warm-up call of a first run),
    none missed; a second run of equal shapes captures nothing new. The
    last epoch's validation metrics equal an eager pass over the final
    weights (a fold baked into the graph at capture would not), and the
    model handed back, whose folds were cached before the run, folds as
    a fresh fold does."""
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.kernels import reset_launch_counts
    from segtpu_torch.models.attention import AttentionGate
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import TrainState, get_engine
    from segtpu_torch.train.loop import _materialize
    fused_run.RUNNERS.clear()
    reset_launch_counts()
    _fit(cuda, True)
    runner = fused_run.RUNNERS[fused_run.RUNNERS.keys()[-1]]
    warm = runner.stats["warmup_calls"]
    val_forwards = 3 * 2 + warm["eval_full"] + warm["eval_rem"]
    assert launch_counts()["attention_gate"] == 4 * val_forwards

    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo"}, device=cuda)
    imgs, masks = _blob_arrays(16, 64, 0)
    vi, vm = _materialize(imgs[10:], masks[10:], device=cuda)
    model = engine.build_model().reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():                      # cache the gates' folds
        model(vi)
    reset_launch_counts()
    second = _fit(cuda, True, initial_state=TrainState(model))
    assert runner.stats["captures"] == 1 and runner.stats["runs"] == 2
    assert launch_counts()["attention_gate"] == 4 * 3 * 2
    assert second["state"].model is model

    final = engine.build_model()
    final.load_state_dict(runner.model.state_dict())
    eager = engine.run_eval_epoch(TrainState(final),
                                  DeviceDataLoader(vi, vm, 4, shuffle=False))
    for k, v in eager.items():
        got = second["val_metrics"][-1][k]
        assert abs(v - got) <= 1e-6 * max(1.0, abs(v)), (k, v, got)
    with torch.no_grad():
        for g in (m for m in model.modules() if isinstance(m,
                                                            AttentionGate)):
            cached, fresh = g.folded(torch.float32), g.fold(torch.float32)
            assert all(torch.equal(a, b) for a, b in zip(cached, fresh))


def test_counted_graph_counts_each_replay(cuda):
    """A gate launch captured in a ``CountedGraph`` counts once per
    replay; one captured by a bare ``torch.cuda.graph`` raises."""
    from segtpu_torch.kernels import CountedGraph
    gen = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda)
    args = [r(2, 8, 8, 16), r(2, 8, 8, 24), r(16, 8) / 4, r(24, 8) / 5,
            r(8) * 0.1, r(8) / 3, torch.full((1,), 0.1, device=cuda)]
    attention_gate(*args)                 # built and loaded outside
    graph = CountedGraph()
    with graph.capture():
        out = attention_gate(*args)
    before = launch_counts()["attention_gate"]
    for _ in range(3):
        graph.replay()
    assert launch_counts()["attention_gate"] - before == 3
    _close(out, attention_gate_plain(*args), torch.float32)
    with pytest.raises(RuntimeError, match="CountedGraph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            attention_gate(*args)


@pytest.mark.parametrize("name,kw", [("adam", {}), ("adamw", {}),
                                     ("sgd", {}), ("sgd", {"nesterov": True}),
                                     ("lamb", {})],
                         ids=["adam", "adamw", "sgd", "sgd-nesterov", "lamb"])
def test_optimizer_step_replayed_equals_eager_on_the_card(cuda, name, kw):
    """``DeviceOptimizer.step()`` captured once in a CUDA graph and
    replayed, with the LR changed between replays, against the same step
    called eagerly: the same bits after each of four replays (an LR or a
    step count baked into the graph would part them at the first cut or
    the first replay)."""
    from segtpu_torch.train.optim import make_optimizer, set_learning_rate
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(64, 32, 3, 3), (1000,), (7, 5)]
    init = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    pa = [t.clone().requires_grad_() for t in init]
    pb = [t.clone().requires_grad_() for t in init]
    eager = make_optimizer(name, pa, 1e-3, 1e-2, **kw)
    opt = make_optimizer(name, pb, 1e-3, 1e-2, **kw)
    for pe, pg in zip(pa, pb):             # a warm-up step, then capture
        pg.grad = torch.randn(pg.shape, generator=gen, device=cuda)
        pe.grad = pg.grad.clone()
    eager.step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step()
    for lr in (1e-3, 1e-3, 5e-4, 2.5e-4):
        grads = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
        for pe, pg, g in zip(pa, pb, grads):
            pe.grad = g.clone()
            pg.grad.copy_(g)
        set_learning_rate(eager, lr)
        eager.step()
        set_learning_rate(opt, lr)
        graph.replay()
        assert all(torch.equal(a, b) for a, b in zip(pa, pb)), lr
    assert float(opt.state[pb[0]]["step"]) == 5.0


@pytest.mark.parametrize("name,kw", [("adam", {}), ("adamw", {}),
                                     ("sgd", {}), ("sgd", {"nesterov": True}),
                                     ("lamb", {})],
                         ids=["adam", "adamw", "sgd", "sgd-nesterov", "lamb"])
def test_optimizer_steps_as_torchs_own_on_the_card(cuda, name, kw):
    """On the card torch runs its optimizers' foreach rules (the port's
    earlier LAMB its per-tensor one); ``DeviceOptimizer`` takes their
    forms, so that the stepwise loop keeps its numbers there: four steps
    with weight decay and a changing LR leave the same bits."""
    from segtpu_torch.train.optim import make_optimizer, set_learning_rate
    from torch_optim_reference import reference_optimizer, set_reference_lr
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(64, 32, 3, 3), (1000,), (7, 5)]
    init = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    pa = [t.clone().requires_grad_() for t in init]
    pb = [t.clone().requires_grad_() for t in init]
    ref = reference_optimizer(name, pa, 1e-3, 1e-2, **kw)
    opt = make_optimizer(name, pb, 1e-3, 1e-2, **kw)
    for lr in (1e-3, 1e-3, 5e-4, 2.5e-4):
        grads = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
        for ps in (pa, pb):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        set_reference_lr(ref, lr)
        ref.step()
        set_learning_rate(opt, lr)
        opt.step()
        assert all(torch.equal(a, b) for a, b in zip(pa, pb)), lr


def test_fused_run_with_remat_replays_as_the_stepwise_loop(deterministic):
    """``remat="full"`` (the forward re-run in backward through
    ``torch.utils.checkpoint``) is a configuration the fused run takes:
    its training step captures, and the run equals the stepwise one as
    ``test_fused_run_replays_every_optimizer_as_the_stepwise_loop``
    holds it."""
    step, fused = (_fit(deterministic, f, remat="full")
                   for f in (False, True))
    assert fused["lr_history"] == step["lr_history"] == [1e-3, 5e-4, 2.5e-4]
    for key in ("train_metrics", "val_metrics"):
        for a, b in zip(fused[key], step[key]):
            assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), key


def test_replayed_run_equals_the_same_steps_run_eagerly(deterministic):
    """A runner's replays against a runner that calls the same steps
    eagerly on the card (``graphs=False``), from the same state: every
    history and every weight equal bit for bit."""
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.train.engine import get_engine
    from segtpu_torch.train.fused_run import FusedRunner
    from segtpu_torch.train.loop import _materialize
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo"}, device=deterministic)
    imgs, masks = _blob_arrays(16, 64, 1)
    ti, tm = _materialize(imgs[:10], masks[:10], device=deterministic)
    vi, vm = _materialize(imgs[10:], masks[10:], device=deterministic)
    outs = []
    for graphs in (True, False):
        state = engine.init_state(torch.Generator().manual_seed(0), 1e-3,
                                  1e-5)
        runner = FusedRunner(engine, state, 10, 6, graphs=graphs)
        outs.append(runner.run(
            state, DeviceDataLoader(ti, tm, 4), DeviceDataLoader(
                vi, vm, 4, shuffle=False),
            torch.Generator(deterministic).manual_seed(1), 3, 1e-3,
            dict(factor=0.5, patience=0, threshold=0.5, min_lr=0.0), 7,
            1e-3))
        assert runner.stats["captures"] == int(graphs)
    a, b = outs
    for key in ("train_history", "val_history", "lr_history", "best_epoch"):
        assert a[key] == b[key], key
    for sa, sb in ((a["state"], b["state"]),
                   (a["final_state"], b["final_state"])):
        da, db = sa.model.state_dict(), sb.model.state_dict()
        assert all(torch.equal(da[k], db[k]) for k in da)


@pytest.fixture
def nccl_world_one(deterministic, tmp_path):
    """An NCCL process group of one rank (this process) and its mesh."""
    from segtpu_torch.core.dist import create_mesh, init_process_group
    init_process_group(f"file://{tmp_path}/rdzv", 1, 0, device="cuda:0")
    try:
        yield create_mesh(device="cuda")
    finally:
        torch.distributed.destroy_process_group()


def test_dp_step_at_world_one_is_the_plain_step(nccl_world_one):
    """``DataParallel`` over one rank (NCCL) takes the single-device
    arithmetic: loss, metrics, every parameter and BatchNorm statistic
    after a bf16 step equal the plain engine's bit for bit."""
    from segtpu_torch.parallel import DataParallel
    from segtpu_torch.train.engine import get_engine
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo", "dtype": "bfloat16"},
                        device="cuda")
    imgs, masks = _blob_arrays(8, 64, 2)
    x = (torch.from_numpy(imgs[:, None]).float() / 255).cuda().contiguous(
        memory_format=torch.channels_last)
    y = torch.from_numpy(masks[:, None]).float().cuda()
    dp = DataParallel(nccl_world_one)
    outs = []
    for shard in (dp.shard, lambda t: t):
        state = engine.init_state(torch.Generator().manual_seed(0), 1e-3,
                                  1e-5)
        dp.replicate(state)
        state, m = engine.train_step(state, shard(x), shard(y))
        outs.append((torch.stack(list(m.values())).cpu(),
                     state.model.state_dict()))
    (ma, da), (mb, db) = outs
    assert torch.equal(ma, mb)
    assert all(torch.equal(da[k], db[k]) for k in da)


def test_synced_batchnorm_at_world_one_equals_cudnns(nccl_world_one):
    """The global-batch BatchNorm (E[x²] − E[x]², one NCCL all-reduce of
    the sums) at world 1 on the card against the class's cuDNN train-mode
    forward: outputs, input and weight gradients (of a random projection
    of the output, whose input gradient BatchNorm's backward does not
    cancel) within 1e-5 of their scale; both move the running variance
    by the biased variance."""
    from segtpu_torch.models.backbones import BatchNorm2d, synced_batch_stats
    from segtpu_torch.parallel.data_parallel import StepSync
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(4, 32, 16, 16, generator=gen, device="cuda") * 3 + 1
         ).contiguous(memory_format=torch.channels_last)
    proj = torch.randn(x.shape, generator=gen, device="cuda")
    res = []
    for sync in (None, StepSync(nccl_world_one.get_group(0), 4)):
        bn = BatchNorm2d(32, device="cuda").train()
        xi = x.clone().requires_grad_(True)
        with synced_batch_stats(bn, sync):
            out = bn(xi)
            (out * proj).sum().backward()
        res.append((out.detach(), xi.grad, bn.weight.grad,
                    bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(*res):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    var = x.float().var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(res[1][4], 0.9 + 0.1 * var, rtol=1e-5,
                               atol=0)


def test_halo_rows_over_one_nccl_rank_are_the_band_and_its_padding(
        nccl_world_one):
    """A spatial axis of one rank (NCCL, CUDA tensors): the band is the
    whole image, so ``halo_rows`` gives it back with rows of the layer's
    padding above and below (zeros for a conv, −inf for the max-pool),
    and its adjoint hands the band its own rows' gradients (those of the
    padding dropped)."""
    from segtpu_torch.core.dist import halo_rows
    group = nccl_world_one.get_group(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 3, 8, 5, generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    for fill, top, bottom in ((0.0, 2, 1), (float("-inf"), 1, 0)):
        y = halo_rows(x, top, bottom, fill, group)
        assert y.is_cuda and y.shape == (2, 3, 8 + top + bottom, 5)
        assert torch.equal(y[:, :, top:top + 8], x.detach())
        assert bool((y[:, :, :top] == fill).all())
        assert bool((y[:, :, top + 8:] == fill).all())
        g = torch.randn(y.shape, generator=gen, device="cuda")
        x.grad = None
        y.backward(g)
        assert torch.equal(x.grad, g[:, :, top:top + 8])


def test_collectives_replay_from_a_cuda_graph_at_world_one(nccl_world_one):
    """The port's collective helpers (``core/dist.py``) captured in one
    CUDA graph on an NCCL group of one rank, after eager warm-up calls
    that create the communicator, then replayed twice on new inputs:
    each output equals the eager call's on the same inputs, bit for bit.
    At world 1 the sums are the identity, so this holds the capture
    itself: every helper enqueues on the capturing stream with no host
    sync and no shape-dependent host branch, and reads its static
    buffers at replay."""
    from segtpu_torch.core.dist import (all_gather_rows, all_reduce_,
                                        all_reduce_sum, broadcast_)
    group = nccl_world_one.get_group(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1 << 20,), (2, 96), (4096,), (3, 5, 7)]

    def calls(a, b, c, d):
        return (all_reduce_(a, group), all_reduce_sum(b, group),
                broadcast_(c, 0, group), all_gather_rows(d, 3, group))

    static = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    calls(*[t.clone() for t in static])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls(*static)
    for _ in range(2):
        fresh = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
        for t, f in zip(static, fresh):
            t.copy_(f)
        graph.replay()
        want = calls(*fresh)
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)


def _fused_dp_run(engine, mesh, data, **kw):
    from segtpu_torch.train.fused_run import run_training_fused
    state = engine.init_state(torch.Generator().manual_seed(0), 1e-3, 1e-5)
    return run_training_fused(
        engine, state, *data, batch_size=4, num_epochs=3, lr0=1e-3,
        generator=torch.Generator("cuda").manual_seed(1),
        scheduler_params=dict(factor=0.5, patience=0, threshold=0.5,
                              min_lr=0.0), mesh=mesh, **kw)


def test_dp_fused_run_at_world_one_equals_the_one_process_run(
        nccl_world_one):
    """``run_training_fused`` on an NCCL mesh of one rank (resnet_tiny with
    attention, 64², f32) captures graphs of its own, keyed apart from the
    one-process runner's, and its histories, decisions and final weights
    equal the one-process fused run's bit for bit (at world 1 the
    data-parallel step is the plain step); a second run of equal shapes
    replays without capturing."""
    from segtpu_torch.kernels import reset_launch_counts
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import get_engine
    from segtpu_torch.train.loop import _materialize
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo"}, device="cuda")
    imgs, masks = _blob_arrays(16, 64, 3)
    data = (*_materialize(imgs[:10], masks[:10], device="cuda"),
            *_materialize(imgs[10:], masks[10:], device="cuda"))
    fused_run.RUNNERS.clear()
    one = _fused_dp_run(engine, None, data)
    reset_launch_counts()
    dp = _fused_dp_run(engine, nccl_world_one, data)
    keys = fused_run.RUNNERS.keys()
    assert len(keys) == 2 and keys[0] != keys[1]
    runner = fused_run.RUNNERS[keys[-1]]
    assert runner.stats["captures"] == 1 and runner.placement is not None
    warm = runner.stats["warmup_calls"]
    val = dp["epochs_ran"] * 2 + warm["eval_full"] + warm["eval_rem"]
    assert launch_counts()["attention_gate"] == 4 * val
    for key in ("train_history", "val_history", "lr_history", "best_epoch",
                "epochs_ran"):
        assert dp[key] == one[key], key
    da, db = (r["final_state"].model.state_dict() for r in (dp, one))
    assert all(torch.equal(da[k], db[k]) for k in da)
    again = _fused_dp_run(engine, nccl_world_one, data)
    assert runner.stats["captures"] == 1 and runner.stats["runs"] == 2
    assert again["val_history"] == dp["val_history"]


def test_dp_fused_run_captures_its_collectives_at_world_one(
        nccl_world_one):
    """The DP fused run on an NCCL mesh of one rank with the one-rank group
    kept in every step (``chip_smoke.one_rank_sync``; ``local_batch``
    drops it otherwise): the BatchNorms' all-reduces, the gathers and the
    gradients' all-reduce are called while the runner warms up and
    captures, none while a second run replays, and the captured run
    equals the same steps called eagerly bit for bit."""
    from chip_smoke import one_rank_sync
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import get_engine
    from segtpu_torch.train.loop import _materialize
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo"}, device="cuda")
    imgs, masks = _blob_arrays(16, 64, 5)
    data = (*_materialize(imgs[:10], masks[:10], device="cuda"),
            *_materialize(imgs[10:], masks[10:], device="cuda"))
    group = nccl_world_one.get_group(0)
    fused_run.RUNNERS.clear()
    first, again_calls, eager_calls = {}, {}, {}
    with one_rank_sync(group, first):
        got = _fused_dp_run(engine, nccl_world_one, data)
    with one_rank_sync(group, again_calls):
        again = _fused_dp_run(engine, nccl_world_one, data)
    (key,) = fused_run.RUNNERS.keys()
    assert fused_run.RUNNERS[key].stats["captures"] == 1
    assert first["all_reduce"] > 0 and first["all_gather"] > 0
    assert not again_calls
    state = engine.init_state(torch.Generator().manual_seed(0), 1e-3, 1e-5)
    runner = fused_run.FusedRunner(engine, state, 10, 6, graphs=False,
                                   placement=fused_run.Placement(
                                       nccl_world_one))
    with one_rank_sync(group, eager_calls):
        want = runner.run(state, DeviceDataLoader(*data[:2], 4),
                          DeviceDataLoader(*data[2:], 4, shuffle=False),
                          torch.Generator("cuda").manual_seed(1), 3, 1e-3,
                          dict(factor=0.5, patience=0, threshold=0.5,
                               min_lr=0.0), 7, 1e-3)
    assert eager_calls["all_reduce"] > 0
    for out in (again, want):
        for key in ("train_history", "val_history", "lr_history",
                    "best_epoch", "epochs_ran"):
            assert out[key] == got[key], key
        da, db = (r["final_state"].model.state_dict() for r in (out, got))
        assert all(torch.equal(da[k], db[k]) for k in da)


def test_fused_run_refuses_capture_on_a_gloo_mesh(deterministic, tmp_path):
    """On gloo a CUDA tensor goes through host memory, which a CUDA graph
    cannot capture: the runner raises before capturing anything (no
    eager fallback) and caches nothing; ``graphs=False`` runs the same
    steps eagerly there."""
    from segtpu_torch.core.dist import create_mesh, init_process_group
    from segtpu_torch.data.loader import DeviceDataLoader
    from segtpu_torch.train import fused_run
    from segtpu_torch.train.engine import get_engine
    from segtpu_torch.train.loop import _materialize
    engine = get_engine({"backbone": "resnet_tiny", "use_attention": True,
                         "loss_fn": "combo"}, device="cuda")
    imgs, masks = _blob_arrays(8, 64, 4)
    data = (*_materialize(imgs[:6], masks[:6], device="cuda"),
            *_materialize(imgs[6:], masks[6:], device="cuda"))
    init_process_group(f"file://{tmp_path}/rdzv", 1, 0, device="cuda:0",
                       backend="gloo")
    try:
        mesh = create_mesh(device="cuda")
        fused_run.RUNNERS.clear()
        with pytest.raises(RuntimeError, match="cannot capture"):
            _fused_dp_run(engine, mesh, data)
        assert len(fused_run.RUNNERS) == 0
        state = engine.init_state(torch.Generator().manual_seed(0), 1e-3,
                                  1e-5)
        runner = fused_run.FusedRunner(
            engine, state, 6, 2, graphs=False,
            placement=fused_run.Placement(mesh))
        out = runner.run(state, DeviceDataLoader(*data[:2], 4),
                         DeviceDataLoader(*data[2:], 4, shuffle=False),
                         torch.Generator("cuda").manual_seed(1), 1, 1e-3,
                         None, 7, 1e-3)
        assert out["epochs_ran"] == 1 and runner.stats["captures"] == 0
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_stem_s2d_equals_the_plain_stem_on_the_card(cuda, dtype):
    """The ResNets' stem on a 512² batch: its space-to-depth form (a
    4×4/s1 conv over ``pixel_unshuffle``) against its plain 7×7/s2 conv,
    at inference and, with ``reparam_in_train``, the weight's gradient
    in train mode, within the file's bars of the output's scale."""
    from segtpu_torch.models.backbones import GrayStem
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(4, 1, 512, 512, generator=gen, device="cuda").to(
        dtype).contiguous(memory_format=torch.channels_last)
    stem = GrayStem(device="cuda", dtype=dtype, reparam_in_train=True)
    proj = torch.randn(4, 64, 256, 256, generator=gen, device="cuda")
    out, grads = {}, {}
    for s2d in (True, False):
        stem.s2d = s2d
        with torch.no_grad():
            out[s2d] = stem.eval()(x)
        stem.weight.grad = None
        (stem.train()(x).float() * proj).sum().backward()
        grads[s2d] = stem.weight.grad.clone()
    _close(out[True], out[False].float(), dtype)
    _close(grads[True], grads[False].float(), dtype)


_NCCL_TWO_RANKS = """\
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]),
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(1, device="cuda")
try:
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("all_reduce ran")
except Exception as e:
    print("refused:", e)
"""


def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """Why ``chip_smoke.py``'s world-2 phase runs on gloo: NCCL refuses
    two ranks on one device ("Duplicate GPU detected")."""
    import subprocess
    import sys
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NCCL_TWO_RANKS, f"file://{tmp_path}/rdzv",
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("two NCCL ranks on one card hung past 120 s")
    for out in outs:
        assert "Duplicate GPU detected" in out, out[-2000:]
