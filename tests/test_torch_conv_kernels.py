"""The port's conv kernels (``conv3x3_bn_relu``, ``conv_pair_bn_relu``) vs
the JAX package's Pallas kernels and XLA oracles, on the same numpy
inputs.

On the CPU each wrapper takes its plain version, so these tests hold the
plain versions (which ``chip_smoke.py`` holds the CUDA kernels against on
the card) to ``conv3x3_bn_relu_pallas``/``conv_pair_bn_relu_pallas`` run
in interpret mode and to their ``_xla`` oracles. f32 tolerance: atol
1e-4, the bar of tests/test_kernels.py for these kernels.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from segtpu.kernels.fused_block import (conv_pair_bn_relu_pallas,
                                        conv_pair_bn_relu_xla)
from segtpu.kernels.fused_conv import (conv3x3_bn_relu_pallas,
                                       conv3x3_bn_relu_xla,
                                       upsample2x_concat_pallas,
                                       upsample2x_concat_xla)
from segtpu.models.unet import UNetWithBackbone as JaxUNet
from segtpu.models.unet import _DecoderBlock as JaxDecoderBlock
from segtpu_torch.kernels import _build, launch_counts
from segtpu_torch.kernels.fused_block import (BF16_TILES, F32_TILE,
                                              SMEM_LIMIT, conv_pair_bn_relu,
                                              pair_tile, smem_bytes)
from segtpu_torch.kernels.fused_conv import conv3x3_bn_relu, upsample2x_concat
from segtpu_torch.models.convert import conv_transpose_weight, state_dict_from_jax
from segtpu_torch.models.unet import UNetWithBackbone
from torch_jax_init import drawn_variables

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_params(rng, cin, cout):
    """HWIO weight and f32 scale/bias, numpy."""
    return ((rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, cout).astype(np.float32),
            rng.normal(size=cout).astype(np.float32))


def _pair_inputs(rng, b, h, w, cin, c):
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    return (x,) + _conv_params(rng, cin, c) + _conv_params(rng, c, c)


# (B, H, W, Cin, Cout) at the Pallas kernel's tile of 16: the case of
# tests/test_kernels.py and a non-square one with other widths.
SHAPES = [(2, 32, 32, 8, 16), (1, 16, 32, 12, 24)]
IDS = ["2x32x32x8-16", "1x16x32x12-24"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_plain_matches_pallas_and_xla(rng, shape):
    b, h, w, cin, cout = shape
    args = (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            ) + _conv_params(rng, cin, cout)
    jx = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = conv3x3_bn_relu_pallas(*jx, tile=16)
    ref_xla = conv3x3_bn_relu_xla(*jx)
    got = conv3x3_bn_relu(*[_t(a) for a in args], tile=16).numpy()
    assert got.shape == (b, h, w, cout)
    np.testing.assert_allclose(got, np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ref_xla), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv_pair_plain_matches_pallas_and_xla(rng, shape):
    """Including the border rows and columns, where the intermediate must
    be zero outside the image ('same' padding of conv 2)."""
    args = _pair_inputs(rng, *shape)
    jx = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(conv_pair_bn_relu_pallas(*jx, tile=16))
    ref_xla = np.asarray(conv_pair_bn_relu_xla(*jx))
    got = conv_pair_bn_relu(*[_t(a) for a in args], tile=16).numpy()
    np.testing.assert_allclose(got, ref_pallas, atol=ATOL)
    np.testing.assert_allclose(got, ref_xla, atol=ATOL)
    for border in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert np.abs(ref_xla[border]).max() > 0.1    # not vacuous
        np.testing.assert_allclose(got[border], ref_pallas[border], atol=ATOL)
        np.testing.assert_allclose(got[border], ref_xla[border], atol=ATOL)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("which", ["conv3x3", "pair"])
def test_bf16_plain_matches_xla(rng, which):
    """bf16 in and out. Both sides sum the bf16 products in f32 and round
    the result to bf16 once, so they may sit one bf16 ulp (≤ 2^-7 of the
    value) apart; the pair also rounds its intermediate, where a one-ulp
    flip is carried through conv 2 at a small share of it. Tolerance:
    2^-6 of the output's scale (at least 1)."""
    x, w1, s1, b1, w2, s2, b2 = _pair_inputs(rng, 2, 16, 16, 8, 16)
    args = (x, w1, s1, b1) if which == "conv3x3" else (x, w1, s1, b1, w2,
                                                       s2, b2)
    half = {0, 1, 4}                              # x, w1, w2 are bf16
    jx = [_bf16(a) if i in half else jnp.asarray(a)
          for i, a in enumerate(args)]
    tx = [_t(a).to(torch.bfloat16) if i in half else _t(a)
          for i, a in enumerate(args)]
    if which == "conv3x3":
        ref, got = conv3x3_bn_relu_xla(*jx), conv3x3_bn_relu(*tx)
    else:
        ref, got = conv_pair_bn_relu_xla(*jx), conv_pair_bn_relu(*tx)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=2.0 ** -6 * max(1.0, np.abs(ref).max()))


# H, W not multiples of any tile: against the oracles only, since the
# Pallas kernels assert divisibility.
@pytest.mark.parametrize("shape", [(1, 11, 13, 5, 12), (2, 9, 7, 16, 8)],
                         ids=["11x13", "9x7"])
def test_ragged_plain_matches_xla(rng, shape):
    args = _pair_inputs(rng, *shape)
    jx = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(
        conv3x3_bn_relu(*[_t(a) for a in args[:4]]).numpy(),
        np.asarray(conv3x3_bn_relu_xla(*jx[:4])), atol=ATOL)
    np.testing.assert_allclose(
        conv_pair_bn_relu(*[_t(a) for a in args]).numpy(),
        np.asarray(conv_pair_bn_relu_xla(*jx)), atol=ATOL)


def _randomized_state(seed):
    """The resnet_tiny no-attention JAX model's variables with BN running
    statistics, BN scales and biases drawn from a seeded generator, so the
    folds see non-trivial values."""
    p, s = drawn_variables(JaxUNet(backbone="resnet_tiny",
                                   use_attention=False), 0, (1, 64, 64, 1))
    r = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "mean":
            return (r.normal(size=a.shape) * 0.1).astype(np.float32)
        return r.uniform(0.5, 1.5, a.shape).astype(np.float32)

    def param(path, a):
        a = np.array(a, np.float32)
        if path[-1].key in ("scale", "bias"):
            return a + (r.normal(size=a.shape) * 0.2).astype(np.float32)
        return a

    tmap = jax.tree_util.tree_map_with_path
    return tmap(param, p), tmap(stat, s)


@pytest.mark.parametrize("level", [1, 2])
def test_decoder_block_matches_pair_kernel_and_jax(rng, level):
    """The port's _DecoderBlock, loaded from the JAX model through
    state_dict_from_jax, in eval: equal to conv_pair_bn_relu fed its
    BN-folded HWIO weights, and to the JAX _DecoderBlock with train=False
    on the same input."""
    p, s = _randomized_state(seed=level)
    tm = UNetWithBackbone(backbone="resnet_tiny", use_attention=False,
                          device="cpu")
    tm.load_state_dict(state_dict_from_jax(p, s, "resnet_tiny", False,
                                           device="cpu"), strict=True)
    block = getattr(tm.eval(), f"decoder{level}")
    cin, c = block[0].in_channels, block[0].out_channels
    x = rng.normal(size=(2, 12, 16, cin)).astype(np.float32)

    ref = np.asarray(JaxDecoderBlock(features=c).apply(
        {"params": p[f"decoder{level}"],
         "batch_stats": s[f"decoder{level}"]}, jnp.asarray(x), False))

    def folded(conv, bn):
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        return (conv.weight.permute(2, 3, 1, 0).contiguous(), scale,
                (conv.bias - bn.running_mean) * scale + bn.bias)

    with torch.no_grad():
        got_block = block(_t(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).permute(0, 2, 3, 1).numpy()
        got_kernel = conv_pair_bn_relu(_t(x), *folded(block[0], block[1]),
                                       *folded(block[3], block[4])).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got_block, ref, atol=ATOL)
    np.testing.assert_allclose(got_kernel, ref, atol=ATOL)


# kernel_bench's bench_ups cases that the serving path never runs,
# (32², 512→256+256) and (128², 64→32+64), at a reduced width with the
# same channel ratios.
@pytest.mark.parametrize("shape", [(2, 4, 4, 16, 8, 8), (2, 8, 8, 8, 4, 8)],
                         ids=["cin2co-cs=co", "cin2co-cs=2co"])
def test_upsample_plain_at_bench_ratios(rng, shape):
    b, h, w, cin, co, cs = shape
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(2, 2, cin, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    skip = rng.normal(size=(b, 2 * h, 2 * w, cs)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, k, bias, skip)]
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = upsample2x_concat_pallas(*jx, tile=4)
    wv = _t(conv_transpose_weight(k)).permute(0, 2, 3, 1).contiguous()
    got = upsample2x_concat(_t(x), wv, _t(bias), _t(skip)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(upsample2x_concat_xla(*jx)),
                               atol=ATOL)


def test_cpu_tensors_take_plain_path_without_launch(rng):
    before = launch_counts()
    args = [_t(a) for a in _pair_inputs(rng, 1, 8, 8, 4, 8)]
    conv3x3_bn_relu(*args[:4])
    conv_pair_bn_relu(*args)
    assert launch_counts() == before


def _refusals():
    """(name, call, exception) for inputs the kernels do not take."""
    x = torch.zeros(1, 4, 4, 8)
    w, s, b = torch.zeros(3, 3, 8, 16), torch.ones(16), torch.zeros(16)
    w2 = torch.zeros(3, 3, 16, 16)
    nchw_view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    wide = 512
    return [
        ("conv-noncontiguous-x", lambda: conv3x3_bn_relu(nchw_view, w, s, b),
         ValueError),
        ("conv-x-float64", lambda: conv3x3_bn_relu(x.double(), w.double(),
                                                   s, b), TypeError),
        ("conv-w-dtype", lambda: conv3x3_bn_relu(x, w.bfloat16(), s, b),
         TypeError),
        ("conv-scale-bf16", lambda: conv3x3_bn_relu(x, w, s.bfloat16(), b),
         TypeError),
        ("conv-w-cin", lambda: conv3x3_bn_relu(x, torch.zeros(3, 3, 4, 16),
                                               s, b), ValueError),
        ("conv-w-5x5", lambda: conv3x3_bn_relu(x, torch.zeros(5, 5, 8, 16),
                                               s, b), ValueError),
        ("conv-bias-length", lambda: conv3x3_bn_relu(x, w, s,
                                                     torch.zeros(8)),
         ValueError),
        ("conv-w-transposed", lambda: conv3x3_bn_relu(
            x, torch.zeros(16, 8, 3, 3).permute(2, 3, 1, 0), s, b),
         ValueError),
        ("conv-3d-x", lambda: conv3x3_bn_relu(x[0], w, s, b), ValueError),
        ("conv-w-other-device", lambda: conv3x3_bn_relu(
            x, w.to("meta"), s, b), ValueError),
        ("pair-w2-shape", lambda: conv_pair_bn_relu(
            x, w, s, b, torch.zeros(3, 3, 8, 16), s, b), ValueError),
        ("pair-s2-dtype", lambda: conv_pair_bn_relu(x, w, s, b, w2,
                                                    s.double(), b),
         TypeError),
        ("pair-too-wide-for-shared-memory", lambda: conv_pair_bn_relu(
            x, torch.zeros(3, 3, 8, wide), torch.ones(wide),
            torch.zeros(wide), torch.zeros(3, 3, wide, wide),
            torch.ones(wide), torch.zeros(wide)), ValueError),
    ]


@pytest.mark.parametrize("case", _refusals(), ids=lambda c: c[0])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    _, call, exc = case
    before = launch_counts()
    with pytest.raises(exc):
        call()
    assert launch_counts() == before


def test_pair_fits_shared_memory_at_every_decoder_width():
    """The flagship's decoder widths (C 32..256) fit one block in f32 and
    bf16; 512 in f32 does not, and the wrapper refuses it."""
    for c in (32, 64, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            assert smem_bytes(c, dtype) <= SMEM_LIMIT
    assert smem_bytes(512, torch.float32) > SMEM_LIMIT


def test_pair_shared_memory_mirror_matches_the_kernel_source():
    """``fused_block.py``'s tile constants are those of
    ``csrc/conv_pair_bn_relu.cu``: the bf16 ``PairTile`` instances in the
    order the launcher tries them, the limit it tries them against, and
    the f32 kernel's tile and chunk. A tile changed in the ``.cu`` alone
    would let the wrapper pass a width whose launch fails on the card."""
    src = (_build.CSRC / "conv_pair_bn_relu.cu").read_text()
    # PairTile<TH, TW, WM, WN, NT, KC, STAGES> (mma.sync, NC = 8·WN·NT)
    # and PairWgTile<TH, TW, WM, WN, KC, STAGES> (wgmma, NC = 64·WN)
    tiles = {}
    for name, kind, args in re.findall(
            r"using (\w+) = (PairTile|PairWgTile)<([\d, ]+)>;", src):
        a = tuple(map(int, args.split(",")))
        tiles[name] = ((a[0], a[1], 8 * a[3] * a[4], a[5], a[6], False)
                       if kind == "PairTile"
                       else (a[0], a[1], 64 * a[3], a[4], a[5], True))
    order = ["NarrowTile", "BigTile", "RectTile", "SmallTile"]
    launches = re.findall(r"return launch_bf16<(\w+)(, true)?>", src)
    assert [n for n, _ in launches] == order
    # the launcher's kernel for each tile is the one its mirror names
    assert [bool(w) for _, w in launches] == [t[5] for t in BF16_TILES]
    assert "if (c <= NarrowTile::NC)" in src
    for name in order[1:-1]:
        assert f"if ({name}::smem_bytes(c) <= kSmemLimit)" in src
    assert tuple(tiles[n] for n in order) == BF16_TILES
    limit = re.search(r"constexpr long long kSmemLimit = (\d+);", src)
    assert int(limit.group(1)) == SMEM_LIMIT
    f32 = dict(re.findall(r"constexpr int (kT|kKC) = (\d+);", src))
    assert ((int(f32["kT"]),) * 2, int(f32["kKC"])) == (F32_TILE, 16)
    # the smem formulas themselves: ring + M1 rows of Cp + 8 channels,
    # the wgmma ring in 1024-byte stages behind 1024 bytes of alignment
    assert "return kRingBytes + 2LL * M1 * ((c + 15) / 16 * 16 + 8);" in src
    assert ("return 1024 + kRingBytes + 2LL * M1 * ((c + 15) / 16 * 16 + 8);"
            in src)
    assert "(kWeightBytes + kWindowBytes + 1023) / 1024 * 1024" in src


@pytest.mark.parametrize("c, tile", [(20, (16, 16)), (32, (16, 16)),
                                     (33, (16, 16)), (192, (16, 16)),
                                     (193, (8, 16)), (256, (8, 16)),
                                     (257, (8, 8)), (401, (8, 8)),
                                     (928, (8, 8))])
def test_pair_bf16_tile_choice(c, tile):
    """16×16 while the 18² intermediate fits beside the ring (C <= 192),
    8×16 up to C = 256 (the flagship's widest), 8×8 above; every width the
    kernel took before its tensor-core redesign (bf16 C <= 928) still
    fits, and 1024 does not."""
    assert pair_tile(c, torch.bfloat16) == tile
    assert smem_bytes(c, torch.bfloat16) <= SMEM_LIMIT
    assert pair_tile(c, torch.float32) == F32_TILE
    assert smem_bytes(1024, torch.bfloat16) > SMEM_LIMIT
