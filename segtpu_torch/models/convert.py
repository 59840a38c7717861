"""Flax variable trees → the port's ``state_dict``.

The inverse of ``segtpu/models/torch_convert.py::load_reference_checkpoint``
for the port's backbones: takes the JAX model's ``params`` and
``batch_stats`` (nested dicts of arrays) and returns a ``state_dict`` that
``UNetWithBackbone.load_state_dict(..., strict=True)`` accepts.

Layout conversions:
- Conv kernel (kh, kw, I, O) → Conv2d weight (O, I, kh, kw);
- ConvTranspose kernel (kh, kw, I, O) → ConvTranspose2d weight
  (I, O, kh, kw) with the spatial flip, W_t[:, :, dy, dx] = k[1-dy, 1-dx]
  (flax's transposed conv does not flip, torch's does);
- BatchNorm scale/bias (params) and mean/var (batch_stats) →
  weight/bias/running_mean/running_var (+ ``num_batches_tracked`` = 0);
- ``attention{l}/BatchNorm_{0,1,2}`` → ``W_g.1``, ``W_x.1``, ``psi.1``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from segtpu_torch import resolve_device
from segtpu_torch.models.backbones import RESNET_BLOCKS


def conv_weight(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def conv_transpose_weight(kernel) -> np.ndarray:
    k = np.transpose(np.asarray(kernel, np.float32), (2, 3, 0, 1))
    return k[:, :, ::-1, ::-1]


def state_dict_from_jax(params: Dict, batch_stats: Dict,
                        backbone: str = "resnet34",
                        use_attention: bool = True, *,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX ``UNetWithBackbone``'s variables."""
    if backbone not in RESNET_BLOCKS:
        raise ValueError(f"Unknown or not yet ported backbone: {backbone}")
    dev = resolve_device(device)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, p, transform=conv_weight):
        sd[key + ".weight"] = transform(p["kernel"])
        if "bias" in p:
            sd[key + ".bias"] = np.asarray(p["bias"], np.float32)

    def bn(key, p, s):
        sd[key + ".weight"] = np.asarray(p["scale"], np.float32)
        sd[key + ".bias"] = np.asarray(p["bias"], np.float32)
        sd[key + ".running_mean"] = np.asarray(s["mean"], np.float32)
        sd[key + ".running_var"] = np.asarray(s["var"], np.float32)
        sd[key + ".num_batches_tracked"] = np.array(0, np.int64)

    ep, es = params["encoder"], batch_stats["encoder"]
    conv("input_conv", ep["input_conv"])
    bn("bn1", ep["bn1"], es["bn1"])
    for li, n in enumerate(RESNET_BLOCKS[backbone]):
        for bi in range(n):
            fp, tk = f"layer{li + 1}_{bi}", f"enc{li + 1}.{bi}"
            for c, b in (("conv1", "bn1"), ("conv2", "bn2")):
                conv(f"{tk}.{c}", ep[fp][c])
                bn(f"{tk}.{b}", ep[fp][b], es[fp][b])
            if "down_conv" in ep[fp]:
                conv(f"{tk}.downsample.0", ep[fp]["down_conv"])
                bn(f"{tk}.downsample.1", ep[fp]["down_bn"], es[fp]["down_bn"])

    for lvl in (4, 3, 2, 1):
        conv(f"upconv{lvl}", params[f"upconv{lvl}"], conv_transpose_weight)
        dp, ds = params[f"decoder{lvl}"], batch_stats[f"decoder{lvl}"]
        conv(f"decoder{lvl}.0", dp["conv1"])
        bn(f"decoder{lvl}.1", dp["bn1"], ds["bn1"])
        conv(f"decoder{lvl}.3", dp["conv2"])
        bn(f"decoder{lvl}.4", dp["bn2"], ds["bn2"])
        if use_attention:
            ap, as_ = params[f"attention{lvl}"], batch_stats[f"attention{lvl}"]
            for i, (c, t) in enumerate((("W_g", "W_g"), ("W_x", "W_x"),
                                        ("psi", "psi"))):
                conv(f"attention{lvl}.{t}.0", ap[c])
                bn(f"attention{lvl}.{t}.1", ap[f"BatchNorm_{i}"],
                   as_[f"BatchNorm_{i}"])
            cp = params[f"ch_attention{lvl}"]
            conv(f"ch_attention{lvl}.fc.0", cp["fc1"])
            conv(f"ch_attention{lvl}.fc.2", cp["fc2"])
    conv("upconv0", params["upconv0"], conv_transpose_weight)
    conv("conv_final", params["conv_final"])
    return {k: torch.from_numpy(np.array(v, order="C")).to(dev)
            for k, v in sd.items()}
