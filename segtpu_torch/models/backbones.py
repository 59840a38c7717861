"""Encoders for the U-Net, NCHW/channels_last PyTorch.

Port of ``segtpu/models/backbones.py``: ``resnet34`` (BasicBlock),
``resnet50`` (Bottleneck), ``densenet121`` and the test-scale
``resnet_tiny`` (one BasicBlock per stage, resnet34's channel plan). The
grayscale stem is the plain 7×7/s2 conv; the JAX package's ``stem_s2d``
inference rewrite is not ported (ROADMAP A2).

Module names follow the reference/torchvision naming (``input_conv``,
``bn1``, ``enc1.0.conv1``, ``enc1.0.conv3``, ``enc2.0.downsample.0``;
``features.norm0``, ``features.denseblock1.denselayer1.conv1``,
``features.transition1.conv``) so a reference checkpoint loads with
``strict=True``.

Every BatchNorm is ``BatchNorm2d`` below: ``nn.BatchNorm2d`` with flax's
train-mode update of the running variance.

Returns the 5 skip features (x1..x5) at strides /2, /4, /8, /16, /32.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch import resolve_device

BACKBONE_CHANNELS = {
    "resnet34": (64, 64, 128, 256, 512),
    "resnet50": (64, 256, 512, 1024, 2048),
    "densenet121": (64, 256, 512, 1024, 1024),
    # Test-scale stub: resnet34's stride/channel plan, one block per stage.
    "resnet_tiny": (64, 64, 128, 256, 512),
}
RESNET_BLOCKS = {"resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3),
                 "resnet_tiny": (1, 1, 1, 1)}
# The ResNets built from Bottleneck blocks (the others: BasicBlock).
BOTTLENECK = frozenset({"resnet50"})
# densenet121: layers per dense block and the growth rate.
DENSENET_BLOCKS, DENSENET_GROWTH = (6, 12, 24, 16), 32


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same ``state_dict``, ``momentum=0.1``,
    ``eps=1e-5``) whose train-mode forward moves ``running_var`` by the
    *biased* batch variance, as flax's ``BatchNorm`` does
    (``ra_var = m·ra_var + (1−m)·var``); torch's own update uses the
    unbiased one, n/(n−1) larger, which at a 1×1 level with B=2 doubles
    it. The batch is normalised by the biased variance either way.
    ``num_batches_tracked`` counts the updates (the attention gate's fold
    cache reads it). With ``update_stats`` False a train-mode forward
    leaves the running statistics alone (``frozen_running_stats``).

    A channel with one value per batch (B·H·W = 1: one image at a 1×1
    level) is normalised as flax does it, with variance 0: the output is
    the shift, ``running_mean`` moves toward x and ``running_var`` toward
    0. ``F.batch_norm`` refuses that input (its unbiased variance is
    0/0), so that case takes the formula written out."""

    def __init__(self, num_features: int, **kw):
        super().__init__(num_features, **kw)
        self.update_stats = True
        # scratch for the batch's mean and unbiased variance (not state):
        # torch's update with momentum 1 writes them here
        self.register_buffer("_batch_mean", torch.zeros_like(
            self.running_mean), persistent=False)
        self.register_buffer("_batch_var", torch.ones_like(
            self.running_var), persistent=False)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._forward_one_value(x)
        # momentum 1 leaves the batch's mean and unbiased variance in the
        # scratch; fold them in with the biased variance (the same op
        # either way, so that a checkpointed re-run saves what the forward
        # saved)
        mean, var = self._batch_mean, self._batch_var
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        if not self.update_stats:
            return out
        m = self.momentum
        with torch.no_grad():
            self.running_mean.lerp_(mean, m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _forward_one_value(self, x):
        """Train-mode forward of a (1, C, 1, 1) input: x − mean is 0, so
        the output is the shift, and x and the weight get zero gradients,
        as in flax (a zero, not a missing one: weight decay and Adam's
        moments still move the weight)."""
        xc = x - x
        shape = (1, -1, 1, 1)
        out = xc * (self.weight.view(shape) * (self.eps ** -0.5)) \
            + self.bias.view(shape)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(x.reshape(-1).to(
                    self.running_mean.dtype), self.momentum)
                self.running_var.mul_(1.0 - self.momentum)
                self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Within it, train-mode forwards of ``model``'s BatchNorms leave
    their running statistics alone: for the forward that
    ``torch.utils.checkpoint`` re-runs in backward, so that a step updates
    them once, as ``jax.checkpoint`` does."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


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
        self.bn1 = BatchNorm2d(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False, **kw)
        self.bn2 = BatchNorm2d(cout, **kw)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False, **kw),
                BatchNorm2d(cout, **kw))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck block (1×1 → 3×3(stride) → 1×1·4), with a
    projection when the stride or the channels change (so ``enc1.0``
    projects 64 → 256 at stride 1)."""
    EXPANSION = 4

    def __init__(self, cin: int, width: int, stride: int = 1, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        cout = width * self.EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False, **kw)
        self.bn1 = BatchNorm2d(width, **kw)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False, **kw)
        self.bn2 = BatchNorm2d(width, **kw)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False, **kw)
        self.bn3 = BatchNorm2d(cout, **kw)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False, **kw),
                BatchNorm2d(cout, **kw))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
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

    def __init__(self, block_counts, bottleneck: bool = False, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        block = Bottleneck if bottleneck else BasicBlock
        expansion = Bottleneck.EXPANSION if bottleneck else 1
        self.input_conv = nn.Conv2d(1, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = BatchNorm2d(64, **kw)
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            block_counts)):
            blocks = []
            for bi in range(n):
                blocks.append(block(cin, width,
                                    2 if (bi == 0 and li > 0) else 1, **kw))
                cin = width * expansion
            self.add_module(f"enc{li + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        return resnet_features(self, x)


class DenseLayer(nn.Module):
    """DenseNet layer: BN→ReLU→1×1(4k)→BN→ReLU→3×3(k), concatenated
    after its input."""

    def __init__(self, cin: int, growth: int = DENSENET_GROWTH, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.norm1 = BatchNorm2d(cin, **kw)
        self.conv1 = nn.Conv2d(cin, 4 * growth, 1, bias=False, **kw)
        self.norm2 = BatchNorm2d(4 * growth, **kw)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False,
                               **kw)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    """BN→ReLU→1×1 conv→2×2/2 average pool."""

    def __init__(self, cin: int, cout: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.norm = BatchNorm2d(cin, **kw)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, **kw)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, stride=2)


class _DenseFeatures(nn.Module):
    """The reference's ``features`` of densenet121 that its encoder runs:
    ``norm0``, ``denseblock1..4`` and ``transition1..3`` (the 3-channel
    ``conv0`` and the final ``norm5`` are unused, so absent)."""

    def __init__(self, *, device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm0 = BatchNorm2d(64, **kw)
        ch = 64
        for bi, n in enumerate(DENSENET_BLOCKS):
            self.add_module(f"denseblock{bi + 1}", nn.Sequential(
                OrderedDict((f"denselayer{li + 1}",
                             DenseLayer(ch + li * DENSENET_GROWTH, **kw))
                            for li in range(n))))
            ch += n * DENSENET_GROWTH
            if bi < len(DENSENET_BLOCKS) - 1:
                self.add_module(f"transition{bi + 1}",
                                Transition(ch, ch // 2, **kw))
                ch //= 2


def densenet_features(m: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    """x1..x5 of a module holding ``input_conv`` and ``features`` (a
    ``DenseNetEncoder``, or the U-Net): x1 is the stem conv's output with
    no BatchNorm and no ReLU; x2..x5 are the raw dense-block outputs (no
    ``norm5``), as the reference extracts them."""
    x1 = m.input_conv(x)
    f = m.features
    y = _maxpool_3x3_s2(F.relu(f.norm0(x1)))
    feats = [x1]
    for bi in range(1, len(DENSENET_BLOCKS) + 1):
        y = getattr(f, f"denseblock{bi}")(y)
        feats.append(y)
        if bi < len(DENSENET_BLOCKS):
            y = getattr(f, f"transition{bi}")(y)
    return feats


class DenseNetEncoder(nn.Module):
    """densenet121 encoder with grayscale stem (block config (6, 12, 24,
    16), growth 32); ``forward`` yields x1..x5 with 64, 256, 512, 1024 and
    1024 channels."""

    def __init__(self, *, device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.input_conv = nn.Conv2d(1, 64, 7, 2, 3, bias=False, **kw)
        self.features = _DenseFeatures(**kw)

    def forward(self, x) -> List[torch.Tensor]:
        return densenet_features(self, x)


def make_encoder(backbone: str, *, device="cuda",
                 dtype=torch.float32) -> nn.Module:
    if backbone == "densenet121":
        return DenseNetEncoder(device=device, dtype=dtype)
    if backbone not in RESNET_BLOCKS:
        raise ValueError(f"Unknown backbone: {backbone}")
    return ResNetEncoder(RESNET_BLOCKS[backbone], backbone in BOTTLENECK,
                         device=device, dtype=dtype)


def encoder_features(backbone: str):
    """The function that computes x1..x5 from the modules of
    ``make_encoder(backbone)``, wherever they sit."""
    return densenet_features if backbone == "densenet121" else \
        resnet_features
