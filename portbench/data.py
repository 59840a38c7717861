"""Inputs and weights made from ``--seed``, on the device, in bulk.

Images are cell-microscopy stand-ins: a background level, discs of a
brighter foreground (the cells, their number per image drawn between the
traffic's ``min_blobs`` and ``max_blobs``, so the foreground share varies
from image to image as it does between fields of view), and Gaussian
noise, in [0, 1], as the port's normalisation leaves images. The masks
are the discs. Sizes never depend on the seed: every seed gives the same
shapes, only other values.

Weights: one normal draw for every parameter of the reference model
together, cut into the leaves and scaled (convolutions by 1/√fan-in,
biases small, BatchNorm scales near 1), then the BatchNorms' running
statistics set by one train-mode pass of the reference model over
``calib`` images of the same kind (momentum 1), so that the eval-mode
forward sees activations of a trained model's scale. The state dict is
handed to the program and to the reference alike.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from portbench.reference.follow import exact_f32
from portbench.reference.unet import UNet


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for one use (``stream``) of ``seed``."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1_000_003 + int(stream)) % (1 << 62))


def blob_images(gen: torch.Generator, n: int, size: int, p: Dict, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, masks), each (n, 1, size, size) float32 on ``device``."""
    kmax = int(p["max_blobs"])
    u = lambda *s: torch.rand(*s, generator=gen, device=device)
    count = torch.randint(int(p["min_blobs"]), kmax + 1, (n,),
                          generator=gen, device=device)
    cy, cx = u(n, kmax) * size, u(n, kmax) * size
    r = p["min_radius"] + u(n, kmax) * (p["max_radius"] - p["min_radius"])
    fg = p["fg_low"] + u(n) * (p["fg_high"] - p["fg_low"])
    bg = p["bg_low"] + u(n) * (p["bg_high"] - p["bg_low"])
    noise = torch.randn(n, size, size, generator=gen, device=device)
    ax = torch.arange(size, device=device, dtype=torch.float32)
    mask = torch.zeros(n, size, size, dtype=torch.bool, device=device)
    for j in range(kmax):
        d2 = (ax[None, :, None] - cy[:, j, None, None]).square() \
            + (ax[None, None, :] - cx[:, j, None, None]).square()
        mask |= (d2 < r[:, j, None, None].square()) \
            & (count > j)[:, None, None]
    m = mask.to(torch.float32)
    img = bg[:, None, None] + (fg - bg)[:, None, None] * m \
        + float(p["noise"]) * noise
    return img.clamp_(0.0, 1.0)[:, None], m[:, None]


def _scaled(model: UNet, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each parameter's slice of ``flat`` (standard normal), scaled for
    its kind."""
    out, at = {}, 0
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            z = flat[at:at + p.numel()].view(p.shape)
            at += p.numel()
            if isinstance(mod, nn.BatchNorm2d):
                v = 1.0 + 0.1 * z if pname == "weight" else 0.1 * z
            elif pname == "weight":
                # (Cout, Cin, kh, kw); a transposed one (Cin, Cout, kh, kw)
                fan_in = (p.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else p.shape[1]) * p.shape[2] * p.shape[3]
                v = z * fan_in ** -0.5
            else:
                v = 0.02 * z
            out[f"{mname}.{pname}" if mname else pname] = v
    return out


def make_weights(model_cfg: Dict, gen: torch.Generator, calib: torch.Tensor,
                 device) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and BatchNorm statistics, float32) of
    one seed for the configuration ``model_cfg``."""
    model = UNet(model_cfg["backbone"], model_cfg["use_attention"],
                 model_cfg["n_classes"]).to(device)
    total = sum(p.numel() for p in model.parameters())
    flat = torch.randn(total, generator=gen, device=device)
    with torch.no_grad():
        for name, v in _scaled(model, flat).items():
            model.get_parameter(name).copy_(v)
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        for bn in bns:
            bn.momentum = 1.0
        model.train()
        with exact_f32():
            model(calib)
        for bn in bns:
            bn.momentum = 0.1
            bn.num_batches_tracked.zero_()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
