"""The plain reference against the port at 64² on the CPU, and the
yardstick's counts against hand counts at one level."""

from __future__ import annotations

import pytest
import torch

from rehearsal import IMAGES, SEED

CFGS = {"unet-r34-att": dict(backbone="resnet34", use_attention=True,
                             n_classes=1),
        "unet-r50-plain": dict(backbone="resnet50", use_attention=False,
                               n_classes=1)}


def _weights_and_images(cfg):
    from portbench import data
    x, y = data.blob_images(data.generator(SEED, 2, "cpu"), 4, 64, IMAGES,
                            "cpu")
    calib, _ = data.blob_images(data.generator(SEED, 3, "cpu"), 4, 64,
                                IMAGES, "cpu")
    sd = data.make_weights(cfg, data.generator(SEED, 1, "cpu"), calib, "cpu")
    return sd, x, y


@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_matches_the_port_in_both_modes(name, cpu_threads):
    from portbench.reference.unet import UNet, combo_loss
    from segtpu_torch.models.unet import UNetWithBackbone
    cfg = CFGS[name]
    sd, x, y = _weights_and_images(cfg)
    ref = UNet(**cfg)
    ref.load_state_dict(sd, strict=True)
    port = UNetWithBackbone(**cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    xl = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        ref.eval(), port.eval()
        a, b = ref(x), port(xl)
    # eval: the port's kernels' plain versions, the s2d stem and the
    # contracted head are exact up to the order of the sums
    assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    ref.train(), port.train()
    la, lb = combo_loss(ref(x), y), combo_loss(port(xl), y)
    assert abs(la.item() - lb.item()) <= 1e-5 * abs(la.item())
    la.backward()
    lb.backward()
    pg = dict(port.named_parameters())
    norms = {n: p.grad.norm().item() for n, p in ref.named_parameters()}
    med = sorted(norms.values())[len(norms) // 2]
    for n, p in ref.named_parameters():
        if norms[n] < 1e-3 * med:
            continue      # a bias ahead of a BatchNorm: rounding alone
        # the check's measure: the gap of the leaf's gradient norms; sums
        # over every pixel in other orders (channels_last against NCHW),
        # some cancelling: 1% of the leaf's norm, far under a wrong term
        gap = abs(pg[n].grad.norm().item() - norms[n])
        assert gap <= 1e-2 * max(norms[n], med), n
    # the running statistics move alike (flax's biased variance)
    rb = dict(ref.named_buffers())
    for n, t in port.state_dict().items():
        if "running" in n:
            assert torch.allclose(rb[n], t, rtol=1e-4, atol=1e-6), n


def test_reference_imports_nothing_of_the_program():
    from portbench import importcheck
    found = importcheck.reference_imports()
    assert "torch" in found
    assert not found & (importcheck.FORBIDDEN | {importcheck.PROGRAM})


def test_forbidden_modules_are_told_by_their_whole_top_level_name():
    from portbench.importcheck import forbidden_loaded
    mods = {"segtpu_torch": 1, "segtpu_torch.api": 1, "jaxtyping": 1,
            "numpy": 1, "segtpu": 1, "segtpu.models": 1, "jax.numpy": 1,
            "jaxlib": 1, "flax.linen": 1}
    assert forbidden_loaded(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                      "segtpu", "segtpu.models"]
    assert forbidden_loaded({"segtpu_torch": 1, "jaxtyping": 1}) == []


def test_forward_macs_count_each_convolution_once():
    from portbench.counts import forward_macs
    # the flagship at 512²: the stem 64·1·49 per output pixel of 256²
    stem = 256 * 256 * 64 * 49
    r34 = forward_macs(CFGS["unet-r34-att"], 512)
    assert 27.5e9 < r34 < 27.8e9 and r34 > stem
    r50 = forward_macs(CFGS["unet-r50-plain"], 512)
    assert 122e9 < r50 < 124e9
    # one decoder block by hand: resnet50's level 3 at 64², its two 3×3
    # convolutions (512+512 → 512, 512 → 512) and its 2×2 transposed one
    # (1024 → 512 over 32² inputs)
    from portbench.reference.unet import UNet
    dec3 = 64 * 64 * 512 * (1024 * 9) + 64 * 64 * 512 * (512 * 9)
    up3 = 32 * 32 * 1024 * 512 * 4
    with torch.device("meta"):
        m = UNet("resnet50", False)
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, i, o, seen=seen: seen.append(
            o.numel() * mod.weight[0].numel() if not isinstance(
                mod, torch.nn.ConvTranspose2d)
            else i[0].numel() * mod.weight[0].numel()))
        for mod in (m.decoder3[0], m.decoder3[3], m.upconv3)]
    with torch.no_grad():
        m(torch.empty(1, 1, 512, 512, device="meta"))
    for h in hooks:
        h.remove()
    assert sorted(seen) == sorted([64 * 64 * 512 * 1024 * 9,
                                   64 * 64 * 512 * 512 * 9, up3])
    assert sum(seen[:2]) + up3 == dec3 + up3 or sum(seen) == dec3 + up3


def test_gate_and_upsample_counts_by_hand_at_one_level():
    from portbench import counts
    # the flagship's gate at level 1, B=16: g (16,256,256,32), x (..,64),
    # F = 32, bf16
    m = 16 * 256 * 256
    nbytes, ops = counts.gate_bytes_ops(m, 32, 64, 32, torch.bfloat16)
    # g and x read, x·psi written (2 bytes each); the folded weights
    # (32 + 64 + 1) × 32 in bf16; the f32 biases 33
    assert nbytes == 2 * m * (32 + 64 + 64) + 2 * 97 * 32 + 4 * 33
    assert ops == 2 * m * 32 * 96 + 3 * m * 32 + m * 64
    t, by = counts.bound(nbytes, ops, torch.bfloat16)
    assert by == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12 * 1e3)
    # resnet50's upsample at level 3, B=16: x (16,32,32,1024) → 512
    # channels at 64², skip 512 channels
    m = 16 * 32 * 32
    nbytes, ops = counts.upsample_bytes_ops(m, 1024, 512, 512,
                                            torch.bfloat16)
    assert nbytes == 2 * (m * 1024 + 4 * m * 512 + 4 * m * 1024
                          + 1024 * 4 * 512) + 4 * 512
    assert ops == 2 * m * 1024 * 2048 + 4 * m * 512
    # 238 MB at 3.35 TB/s (71 µs) just above 68.7 GFLOP at 989 TFLOP/s
    assert counts.bound(nbytes, ops, torch.bfloat16)[1] == "bytes"
