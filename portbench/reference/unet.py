"""The plain reference of both configurations: the attention U-Net of
``SwagMag1213/image-segmentation-project`` (``advanced_models.py:64``,
``UNetWithBackbone``) over a resnet34 or resnet50 encoder, in plain
PyTorch, float32, NCHW.

A frozen copy of ``segtpu_torch/models/{unet,attention,backbones}.py``
(as of commit c6ecb5c) with everything but the mathematics taken out: no
kernel calls, no space-to-depth stem (the 7×7/s2 convolution itself), no
contracted head (``upconv0`` then ``conv_final``), no row bands, no
data-parallel statistics. Module names are the reference's, so a
``state_dict`` moves between this model and the port's with
``strict=True``.

BatchNorm moves ``running_var`` by the biased batch variance (flax's
update, which the port keeps), momentum 0.1, eps 1e-5.

``quantize`` (``fp8.py``) is the control's hook: when set on a model, every
convolution takes its input and weight through it first.

This module imports torch only: nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BACKBONE_CHANNELS = {"resnet34": (64, 64, 128, 256, 512),
                     "resnet50": (64, 256, 512, 1024, 2048)}
RESNET_BLOCKS = {"resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3)}
BOTTLENECK = frozenset({"resnet50"})
# per level 4..1: (upconv out, decoder out), the gates' intermediate width,
# and the head's input channels (models/unet.py:47)
DECODER_PLAN = {
    "resnet34": dict(up=(256, 128, 64, 32), dec=(256, 128, 64, 32),
                     att_int=(128, 64, 32, 32), head_in=32),
    "resnet50": dict(up=(1024, 512, 256, 64), dec=(1024, 512, 256, 64),
                     att_int=(512, 256, 128, 32), head_in=64),
}


class _Quantized:
    """Mixin: a convolution that passes its input and weight through the
    model's ``quantize`` hook (None: unchanged)."""
    quantize: Optional[Callable] = None

    def _operands(self, x):
        q = self.quantize
        if q is None:
            return x, self.weight
        return q(x), q(self.weight)


class Conv2d(_Quantized, nn.Conv2d):
    def forward(self, x):
        x, w = self._operands(x)
        return F.conv2d(x, w, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class ConvTranspose2d(_Quantized, nn.ConvTranspose2d):
    def forward(self, x):
        x, w = self._operands(x)
        return F.conv_transpose2d(x, w, self.bias, self.stride,
                                  self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """Train mode: normalise by the batch's mean and biased variance and
    move the running statistics by them (momentum 0.1). Eval mode: the
    running statistics."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.lerp_(mean, m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    EXPANSION = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * self.EXPANSION
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class AttentionGate(nn.Module):
    """psi = σ(BN(conv1x1(relu(BN(W_g·g) + BN(W_x·x))))); returns x·psi."""

    def __init__(self, f_g, f_l, f_int):
        super().__init__()
        self.W_g = nn.Sequential(Conv2d(f_g, f_int, 1), BatchNorm2d(f_int))
        self.W_x = nn.Sequential(Conv2d(f_l, f_int, 1), BatchNorm2d(f_int))
        self.psi = nn.Sequential(Conv2d(f_int, 1, 1), BatchNorm2d(1),
                                 nn.Sigmoid())

    def forward(self, g, x):
        return x * self.psi(F.relu(self.W_g(g) + self.W_x(x)))


class ChannelAttention(nn.Module):
    """SE-style channel attention over avg- and max-pooled descriptors."""

    def __init__(self, channels, reduction_ratio=16):
        super().__init__()
        hidden = max(channels // reduction_ratio, 1)
        self.fc = nn.Sequential(Conv2d(channels, hidden, 1, bias=False),
                                nn.ReLU(),
                                Conv2d(hidden, channels, 1, bias=False))

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc(avg) + self.fc(mx))


def _decoder_block(cin, features):
    return nn.Sequential(Conv2d(cin, features, 3, padding=1),
                         BatchNorm2d(features), nn.ReLU(),
                         Conv2d(features, features, 3, padding=1),
                         BatchNorm2d(features), nn.ReLU())


def _center_crop_to(x, h, w):
    dh, dw = x.shape[2] - h, x.shape[3] - w
    if dh > 0 or dw > 0:
        return x[:, :, dh // 2: dh // 2 + h, dw // 2: dw // 2 + w]
    return x


class UNet(nn.Module):
    """The U-Net of one configuration: ``backbone`` (resnet34 or
    resnet50), ``use_attention``, ``n_classes``, 1 input channel."""

    def __init__(self, backbone="resnet34", use_attention=True,
                 n_classes=1):
        super().__init__()
        if backbone not in RESNET_BLOCKS:
            raise ValueError(f"reference: unknown backbone {backbone!r}")
        self.use_attention = use_attention
        block = Bottleneck if backbone in BOTTLENECK else BasicBlock
        expansion = Bottleneck.EXPANSION if backbone in BOTTLENECK else 1
        self.input_conv = Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            RESNET_BLOCKS[backbone])):
            blocks = []
            for bi in range(n):
                blocks.append(block(cin, width,
                                    2 if (bi == 0 and li > 0) else 1))
                cin = width * expansion
            self.add_module(f"enc{li + 1}", nn.Sequential(*blocks))
        plan = DECODER_PLAN[backbone]
        enc_ch = BACKBONE_CHANNELS[backbone]
        d_ch = enc_ch[4]
        for lvl in (4, 3, 2, 1):
            i, skip_ch = 4 - lvl, enc_ch[lvl - 1]
            up, dec = plan["up"][i], plan["dec"][i]
            self.add_module(f"upconv{lvl}", ConvTranspose2d(d_ch, up, 2,
                                                            stride=2))
            self.add_module(f"decoder{lvl}", _decoder_block(skip_ch + up,
                                                            dec))
            if use_attention:
                self.add_module(f"attention{lvl}", AttentionGate(
                    up, skip_ch, plan["att_int"][i]))
                self.add_module(f"ch_attention{lvl}", ChannelAttention(dec))
            d_ch = dec
        self.upconv0 = ConvTranspose2d(plan["head_in"], 16, 2, stride=2)
        self.conv_final = Conv2d(16, n_classes, 1)

    def set_quantize(self, fn: Optional[Callable]) -> "UNet":
        """Every convolution's operands through ``fn`` (None: off)."""
        for m in self.modules():
            if isinstance(m, _Quantized):
                m.quantize = fn
        return self

    def features(self, x):
        x1 = F.relu(self.bn1(self.input_conv(x)))
        feats = [x1]
        y = F.max_pool2d(x1, 3, stride=2, padding=1)
        for i in range(1, 5):
            y = getattr(self, f"enc{i}")(y)
            feats.append(y)
        return feats

    def forward(self, x):
        x1, x2, x3, x4, x5 = self.features(x)
        d = x5
        for lvl, skip in zip((4, 3, 2, 1), (x4, x3, x2, x1)):
            up = getattr(self, f"upconv{lvl}")(d)
            if lvl == 1:
                skip = _center_crop_to(skip, up.shape[2], up.shape[3])
            if self.use_attention:
                skip = getattr(self, f"attention{lvl}")(up, skip)
            d = getattr(self, f"decoder{lvl}")(torch.cat([skip, up], dim=1))
            if self.use_attention:
                d = getattr(self, f"ch_attention{lvl}")(d)
        d0 = _center_crop_to(self.upconv0(d), x.shape[2], x.shape[3])
        return self.conv_final(d0)


def combo_loss(logits, targets, alpha: float = 0.5, smooth: float = 1.0):
    """α·BCE-with-logits (mean) + (1−α)·Dice over the whole batch: the
    reference's ``combo`` loss."""
    bce = (F.relu(logits) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits)))).mean()
    pred = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    dice = 1.0 - (2.0 * torch.sum(pred * t) + smooth) / (
        torch.sum(pred) + torch.sum(t) + smooth)
    return alpha * bce + (1.0 - alpha) * dice
