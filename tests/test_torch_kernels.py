"""Port kernels (segtpu_torch.kernels) vs the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, so these tests
hold the plain versions (which chip_smoke.py holds the CUDA kernels
against on the card) to the Pallas kernels run in interpret mode, on the
same numpy inputs.
"""

import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from segtpu.kernels.attention_gate import attention_gate_fused
from segtpu.kernels.fused_conv import (fold_bn as jax_fold_bn,
                                       upsample2x_concat_pallas,
                                       upsample2x_concat_xla)
from segtpu_torch.kernels import WRAPPERS, _build, launch_counts
from segtpu_torch.kernels.attention_gate import attention_gate
from segtpu_torch.kernels.fused_conv import fold_bn, upsample2x_concat
from segtpu_torch.models.convert import conv_transpose_weight


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wv(k):
    """flax ConvTranspose kernel (2,2,Cin,Co) → the kernel's weight view:
    the NHWC view (Cin,2,2,Co) of the torch weight (Cin,Co,2,2)."""
    return _t(conv_transpose_weight(k)).permute(0, 2, 3, 1).contiguous()


def _gate_inputs(rng, b, h, w, cg, cx, f):
    g = rng.normal(size=(b, h, w, cg)).astype(np.float32)
    x = rng.normal(size=(b, h, w, cx)).astype(np.float32)
    ag = (rng.normal(size=(cg, f)) / np.sqrt(cg)).astype(np.float32)
    ax = (rng.normal(size=(cx, f)) / np.sqrt(cx)).astype(np.float32)
    bh = rng.normal(size=(f,)).astype(np.float32)
    ap = (rng.normal(size=(f,)) / np.sqrt(f)).astype(np.float32)
    bp = np.array([0.17], np.float32)
    return g, x, ag, ax, bh, ap, bp


# (B, H, W, Cg, Cx, F): a small case, the flagship level-1 channel plan,
# and a ragged M = 15 that sends the JAX side down its jnp branch.
@pytest.mark.parametrize("shape", [(2, 8, 16, 8, 12, 8),
                                   (2, 8, 8, 32, 64, 32),
                                   (1, 3, 5, 8, 12, 8)],
                         ids=["small", "level1-channels", "ragged-m15"])
def test_attention_gate_plain_matches_pallas(rng, shape):
    args = _gate_inputs(rng, *shape)
    ref = attention_gate_fused(*[jnp.asarray(a) for a in args[:-1]],
                               jnp.float32(args[-1][0]))
    got = attention_gate(*[_t(a) for a in args])
    # atol 1e-5: the bar of tests/test_kernels.py for the gate in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 12, 4),
                                   (2, 8, 8, 32, 16, 16)],
                         ids=["small", "wide"])
def test_upsample_concat_plain_matches_pallas(rng, shape):
    b, h, w, cin, co, cs = shape
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(2, 2, cin, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    skip = rng.normal(size=(b, 2 * h, 2 * w, cs)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, k, bias, skip)]
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = upsample2x_concat_pallas(*jx, tile=8)
    ref_xla = upsample2x_concat_xla(*jx)
    got = upsample2x_concat(_t(x), _wv(k), _t(bias), _t(skip)).numpy()
    assert got.shape == (b, 2 * h, 2 * w, cs + co)
    # atol 1e-4: the bar of tests/test_kernels.py for upsample in f32
    np.testing.assert_allclose(got, np.asarray(ref_pallas), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref_xla), atol=1e-4)


# The gate's plain version against the Pallas kernel at real channel
# widths, (B, H, W, Cg, Cx, F): the flagship's widest gate (level 4) and
# its level 1, and resnet50's widest (its level 4, segtpu/models/unet.py).
# Level 1 packs P = 4 pixels per row, so it takes 32 pixels (8 rows, the
# Pallas kernel's smallest block) to run the Pallas path, not its jnp
# fallback.
@pytest.mark.parametrize("shape", [(1, 4, 4, 256, 256, 128),
                                   (1, 4, 8, 32, 64, 32),
                                   (1, 4, 4, 1024, 1024, 512)],
                         ids=["flagship-level4", "flagship-level1",
                              "resnet50-level4"])
def test_attention_gate_plain_matches_pallas_at_real_widths(rng, shape):
    args = _gate_inputs(rng, *shape)
    ref = attention_gate_fused(*[jnp.asarray(a) for a in args[:-1]],
                               jnp.float32(args[-1][0]))
    got = attention_gate(*[_t(a) for a in args])
    # atol 1e-5, as above: weights scaled by 1/√C keep h O(1) at any width
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# The upsample's plain version against the Pallas kernel (interpret mode)
# at a real decoder level, (B, H, W, Cin, Co, Cs): the flagship's level 3
# and resnet50's level-4 upconv (2048 → 1024 beside a 1024-channel skip).
@pytest.mark.parametrize("shape", [(1, 2, 2, 256, 128, 128),
                                   (1, 2, 2, 2048, 1024, 1024)],
                         ids=["flagship-level3", "resnet50-level4"])
def test_upsample_concat_plain_matches_pallas_at_real_widths(rng, shape):
    b, h, w, cin, co, cs = shape
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(2, 2, cin, co)) / np.sqrt(cin)).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    skip = rng.normal(size=(b, 2 * h, 2 * w, cs)).astype(np.float32)
    jx = [jnp.asarray(a) for a in (x, k, bias, skip)]
    with pltpu.force_tpu_interpret_mode():
        ref = upsample2x_concat_pallas(*jx, tile=2)
    got = upsample2x_concat(_t(x), _wv(k), _t(bias), _t(skip)).numpy()
    assert got.shape == (b, 2 * h, 2 * w, cs + co)
    # atol 1e-4, as above; k scaled by 1/√Cin keeps the sums O(1)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(got[..., :cs], skip)


def test_upsample_tap_mapping():
    """Pins the tap map: output pixel (2h+dy, 2w+dx) gets x[h,w] times the
    torch weight W_t[:, :, dy, dx] = flax k[1-dy, 1-dx]."""
    cin, co = 1, 3
    k = np.arange(2 * 2 * cin * co, dtype=np.float32).reshape(2, 2, cin, co)
    wt = conv_transpose_weight(k)
    for dy in range(2):
        for dx in range(2):
            np.testing.assert_array_equal(wt[:, :, dy, dx], k[1 - dy, 1 - dx])
    x = torch.ones((1, 1, 1, cin))
    skip = torch.full((1, 2, 2, 1), -1.0)
    out = upsample2x_concat(x, _wv(k), torch.zeros(co), skip).numpy()
    for dy in range(2):
        for dx in range(2):
            assert out[0, dy, dx, 0] == -1.0
            np.testing.assert_array_equal(out[0, dy, dx, 1:],
                                          k[1 - dy, 1 - dx, 0])


def test_fold_bn_equivalence(rng):
    """conv → BN(inference) == conv with folded weights, and the fold
    equals the JAX package's fold_bn after the layout change."""
    x = _t(rng.normal(size=(1, 4, 8, 8)).astype(np.float32))
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    sh = rng.normal(size=(6,)).astype(np.float32)
    mean = (rng.normal(size=(6,)) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)

    conv = torch.nn.functional.conv2d
    ref = torch.nn.functional.batch_norm(
        conv(x, _t(w), _t(b), padding=1), _t(mean), _t(var), _t(sc), _t(sh),
        training=False, eps=1e-5)
    wf, bf = fold_bn(*[_t(a) for a in (w, b, sc, sh, mean, var)])
    got = conv(x, wf, bf, padding=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)

    jw, jb = jax_fold_bn(*[jnp.asarray(a) for a in (
        np.transpose(w, (2, 3, 1, 0)), b, sc, sh, mean, var)])
    np.testing.assert_allclose(wf.numpy(),
                               np.transpose(np.asarray(jw), (3, 2, 0, 1)),
                               rtol=1e-6)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_take_plain_path_without_launch(rng):
    before = launch_counts()
    args = [_t(a) for a in _gate_inputs(rng, 1, 4, 4, 8, 8, 8)]
    attention_gate(*args)
    x = _t(rng.normal(size=(1, 4, 4, 8)).astype(np.float32))
    k = rng.normal(size=(2, 2, 8, 4)).astype(np.float32)
    upsample2x_concat(x, _wv(k), torch.zeros(4), torch.zeros((1, 8, 8, 2)))
    assert launch_counts() == before


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    g, x, ag, ax, bh, ap, bp = [_t(a) for a in
                                _gate_inputs(rng, 1, 4, 4, 8, 8, 8)]
    # an NCHW-contiguous tensor's NHWC view is not contiguous: no silent copy
    x_nchw_view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        attention_gate(g, x_nchw_view, ag, ax, bh, ap, bp)
    with pytest.raises(TypeError):
        attention_gate(g, x, ag, ax, bh.double(), ap, bp)
    with pytest.raises(ValueError, match="skip"):
        upsample2x_concat(x, _wv(np.zeros((2, 2, 8, 4), np.float32)),
                          torch.zeros(4), torch.zeros((1, 4, 4, 2)))


# Each wrapper's module and the name of its C argument-type tuple.
ARGTYPES = {"attention_gate": ("attention_gate", "ARGTYPES"),
            "upsample2x_concat": ("fused_conv", "UPSAMPLE_ARGTYPES"),
            "conv3x3_bn_relu": ("fused_conv", "CONV3X3_ARGTYPES"),
            "conv_pair_bn_relu": ("fused_block", "ARGTYPES")}


def test_every_kernel_source_has_a_wrapper():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        WRAPPERS) == sorted(ARGTYPES)


@pytest.mark.parametrize("name", sorted(ARGTYPES))
def test_argtypes_match_the_c_entry(name):
    """The ctypes declaration of ``<name>_launch`` matches the C signature
    in ``csrc/<name>.cu`` parameter for parameter: a pointer or a 64-bit
    count declared as a 32-bit int would be cut, which no CPU run shows."""
    mod, attr = ARGTYPES[name]
    declared = getattr(importlib.import_module(
        f"segtpu_torch.kernels.{mod}"), attr)
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src, re.S)
    c_types = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = []
    for param in sig.group(1).split(","):
        ctype = " ".join(param.split()[:-1])
        want.append(ctypes.c_void_p if "*" in ctype else c_types[ctype])
    assert list(declared) == want
