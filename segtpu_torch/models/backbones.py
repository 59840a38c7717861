"""ResNet encoders for the U-Net, NCHW/channels_last PyTorch.

Port of ``segtpu/models/backbones.py`` for the backbones of the port's
path: ``resnet34`` and the test-scale ``resnet_tiny`` (one BasicBlock per
stage, same channel plan). The grayscale stem is the plain 7×7/s2 conv;
the JAX package's ``stem_s2d`` inference rewrite is not ported (ROADMAP).

Module names follow the reference/torchvision naming (``input_conv``,
``bn1``, ``enc1.0.conv1``, ``enc2.0.downsample.0``, …) so a reference
checkpoint loads with ``strict=True``.

Returns the 5 skip features (x1..x5) at strides /2, /4, /8, /16, /32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch import resolve_device

BACKBONE_CHANNELS = {
    "resnet34": (64, 64, 128, 256, 512),
    # Test-scale stub: resnet34's stride/channel plan, one block per stage.
    "resnet_tiny": (64, 64, 128, 256, 512),
}
RESNET_BLOCKS = {"resnet34": (3, 4, 6, 3), "resnet_tiny": (1, 1, 1, 1)}


def _maxpool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride 2, padding 1)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class BasicBlock(nn.Module):
    """ResNet-34 residual block (2× conv3×3)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(cout, **kw)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False, **kw),
                nn.BatchNorm2d(cout, **kw))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


def resnet_features(m: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    """x1..x5 of a module holding ``input_conv``, ``bn1`` and
    ``enc1``..``enc4`` (a ``ResNetEncoder``, or the U-Net, which holds the
    same modules at its top level to keep the reference's key names)."""
    x1 = F.relu(m.bn1(m.input_conv(x)))
    feats = [x1]
    y = _maxpool_3x3_s2(x1)
    for i in range(1, 5):
        y = getattr(m, f"enc{i}")(y)
        feats.append(y)
    return feats


class ResNetEncoder(nn.Module):
    """ResNet encoder with grayscale stem; ``forward`` yields x1..x5."""

    def __init__(self, block_counts, *, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.input_conv = nn.Conv2d(1, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(64, **kw)
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            block_counts)):
            blocks = [BasicBlock(cin if bi == 0 else width, width,
                                 2 if (bi == 0 and li > 0) else 1, **kw)
                      for bi in range(n)]
            self.add_module(f"enc{li + 1}", nn.Sequential(*blocks))
            cin = width

    def forward(self, x) -> List[torch.Tensor]:
        return resnet_features(self, x)


def make_encoder(backbone: str, *, device="cuda",
                 dtype=torch.float32) -> ResNetEncoder:
    if backbone not in RESNET_BLOCKS:
        raise ValueError(f"Unknown or not yet ported backbone: {backbone}")
    return ResNetEncoder(RESNET_BLOCKS[backbone], device=device, dtype=dtype)
