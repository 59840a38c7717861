"""U-Net with a ResNet backbone and attention (port of
``segtpu/models/unet.py``), NCHW in shape and channels_last in memory.

Inference routes two decoder ops through the port's Hopper kernels:

- ``fuse_gate=True`` (default): each attention gate runs as one fused
  kernel launch (``kernels/attention_gate.py``), 4 per forward;
- ``fuse="kernel"`` (default): without attention, the decoder's
  upsample + skip concat runs as one kernel launch
  (``kernels/fused_conv.py::upsample2x_concat``) at the levels that pass
  the JAX package's routing test (``fuse_min_cin``, ``fuse_min_work`` and
  the divisibility test, kept exactly so both packages fuse the same
  levels). Those thresholds were set from TPU v5e numbers; H100 numbers
  re-set them later (ROADMAP).

Both engage only in eval mode, as in JAX (``train=False``). So do the
two exact reparameterisations, the contracted head (``fuse_head``) and
the ResNets' space-to-depth stem (``stem_s2d``), unless
``reparam_in_train`` engages them in training too. Module names
follow the reference (``input_conv``, ``enc1.0.conv1``, ``upconv4``,
``decoder4.0``, ``attention4.W_g.0``, ``ch_attention4.fc.0``,
``upconv0``, ``conv_final``), so a reference checkpoint loads with
``strict=True``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.kernels.fused_conv import upsample2x_concat
from segtpu_torch.models.attention import AttentionGate, ChannelAttention
from segtpu_torch.models.backbones import (BACKBONE_CHANNELS, BatchNorm2d,
                                           Conv2d, GrayStem,
                                           encoder_features, make_encoder)
from segtpu_torch.ops.resize import resize_bilinear

# Per level (upconv out, decoder out), then the attention-gate
# intermediate dims, as in the JAX package.
_DECODER_PLAN = {
    "resnet34": dict(up=(256, 128, 64, 32), dec=(256, 128, 64, 32),
                     att_int=(128, 64, 32, 32), head_in=32),
    "resnet50": dict(up=(1024, 512, 256, 64), dec=(1024, 512, 256, 64),
                     att_int=(512, 256, 128, 32), head_in=64),
    "densenet121": dict(up=(512, 256, 128, 64), dec=(512, 256, 128, 64),
                        att_int=(256, 128, 64, 32), head_in=64),
}
_DECODER_PLAN["resnet_tiny"] = _DECODER_PLAN["resnet34"]


def _center_crop_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Center-crop the spatial dims of an NCHW tensor."""
    dh, dw = x.shape[2] - h, x.shape[3] - w
    if dh > 0 or dw > 0:
        return x[:, :, dh // 2: dh // 2 + h, dw // 2: dw // 2 + w]
    return x


class _DecoderBlock(nn.Sequential):
    """[conv3×3 → BN → ReLU] ×2 over the concatenated (skip, up) input;
    keys ``0``/``1``/``3``/``4`` as in the reference."""

    def __init__(self, cin: int, features: int, *, device="cuda",
                 dtype=torch.float32):
        kw = dict(device=resolve_device(device), dtype=dtype)
        super().__init__(
            Conv2d(cin, features, 3, padding=1, **kw),
            BatchNorm2d(features, **kw), nn.ReLU(),
            Conv2d(features, features, 3, padding=1, **kw),
            BatchNorm2d(features, **kw), nn.ReLU())


class _UpConv2x(nn.ConvTranspose2d):
    """2×2-stride-2 transposed conv; ``forward(x, skip, fused=True)``
    returns ``cat([skip, upconv(x)], 1)`` from one kernel launch."""

    def __init__(self, cin: int, features: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__(cin, features, 2, stride=2,
                         device=resolve_device(device), dtype=dtype)

    def forward(self, x, skip=None, fused: bool = False):
        if not fused:
            return super().forward(x)
        if skip is None:
            raise ValueError("_UpConv2x: fused=True needs skip")
        # the weight in the activations' dtype (f32 parameters under
        # autocast), as the unfused transposed conv casts it; NHWC views,
        # made contiguous as the attention gate's operands are
        out = upsample2x_concat(x.permute(0, 2, 3, 1).contiguous(),
                                self.weight.to(x.dtype).permute(0, 2, 3, 1)
                                .contiguous(), self.bias.float(),
                                skip.permute(0, 2, 3, 1).contiguous())
        return out.permute(0, 3, 1, 2)


class UNetWithBackbone(nn.Module):
    """Attention U-Net over a resnet34, resnet50, densenet121 or
    resnet_tiny encoder.

    Input NCHW (B, 1, H, W) in channels_last memory; output logits
    (B, n_classes, H, W), or ``(logits, features)`` with
    ``return_features=True`` (x2 resized to x3's size, concatenated with
    x3, float32). ``dtype`` is the parameter and compute type.
    ``stem_s2d`` (a ResNet's space-to-depth stem) and ``fuse_head`` run
    at inference, and with ``reparam_in_train`` in training too, as in
    the JAX package.
    """

    def __init__(self, n_classes: int = 1, backbone: str = "resnet34",
                 use_attention: bool = True, dtype=torch.float32,
                 final_bias_prior: Optional[float] = None,
                 fuse: str = "kernel", fuse_min_cin: int = 96,
                 fuse_min_work: int = 16384, fuse_head: bool = True,
                 fuse_gate: bool = True, reparam_in_train: bool = False,
                 *, device="cuda"):
        super().__init__()
        if fuse not in ("none", "kernel"):
            raise ValueError(f"fuse must be 'none' or 'kernel'; got {fuse!r}")
        if backbone not in _DECODER_PLAN:
            raise ValueError(f"Unknown backbone: {backbone}")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.n_classes = n_classes
        self.backbone = backbone
        self.use_attention = use_attention
        self.fuse = fuse
        self.fuse_min_cin = fuse_min_cin
        self.fuse_min_work = fuse_min_work
        self.fuse_head = fuse_head
        self.fuse_gate = fuse_gate
        self.reparam_in_train = reparam_in_train
        self._routing_batch = None     # set by ``routing_at_batch``

        # the encoder's modules sit at the top level (reference key names)
        for name, mod in make_encoder(
                backbone, reparam_in_train=reparam_in_train,
                **kw).named_children():
            self.add_module(name, mod)
        self._encoder_features = encoder_features(backbone)
        plan = _DECODER_PLAN[backbone]
        enc_ch = BACKBONE_CHANNELS[backbone]
        d_ch = enc_ch[4]
        for lvl in (4, 3, 2, 1):
            i, skip_ch = 4 - lvl, enc_ch[lvl - 1]
            up, dec = plan["up"][i], plan["dec"][i]
            self.add_module(f"upconv{lvl}", _UpConv2x(d_ch, up, **kw))
            self.add_module(f"decoder{lvl}",
                            _DecoderBlock(skip_ch + up, dec, **kw))
            if use_attention:
                self.add_module(f"attention{lvl}", AttentionGate(
                    up, skip_ch, plan["att_int"][i], **kw))
                self.add_module(f"ch_attention{lvl}",
                                ChannelAttention(dec, **kw))
            d_ch = dec
        self.upconv0 = nn.ConvTranspose2d(plan["head_in"], 16, 2, stride=2,
                                          **kw)
        self.conv_final = nn.Conv2d(16, n_classes, 1, **kw)
        self.final_bias_prior = final_bias_prior
        self._set_final_bias_prior()
        self.to(memory_format=torch.channels_last)

    @property
    def stem_s2d(self) -> bool:
        """Whether the stem is a ResNet's with its space-to-depth form on
        (the stem holds the flag; densenet121's stem has no such form)."""
        return isinstance(self.input_conv, GrayStem) and self.input_conv.s2d

    @stem_s2d.setter
    def stem_s2d(self, on: bool) -> None:
        if isinstance(self.input_conv, GrayStem):
            self.input_conv.s2d = bool(on)

    def _set_final_bias_prior(self):
        if self.final_bias_prior is not None:
            # foreground prior p for the final bias, log(p/(1-p))
            p = float(self.final_bias_prior)
            with torch.no_grad():
                self.conv_final.bias.fill_(math.log(p / (1.0 - p)))

    def reset_parameters(self, generator: torch.Generator) -> "UNetWithBackbone":
        """Redraw every parameter as the JAX package's model initialises
        it (flax's defaults): conv and transposed-conv kernels from a
        normal truncated at ±2σ with variance 1/fan_in (fan_in = kernel
        taps × input channels), biases 0, BatchNorm scale 1 and shift 0,
        running statistics reset; then the final-bias prior. The draws
        come from ``generator`` (a CPU generator), in module order, so
        one seed gives the same weights on every device."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                    w = mod.weight
                    cin = w.shape[0] if isinstance(
                        mod, nn.ConvTranspose2d) else w.shape[1]
                    std = (1.0 / (cin * w.shape[2] * w.shape[3])) ** 0.5 \
                        / .87962566103423978
                    t = torch.empty(w.shape, dtype=torch.float32)
                    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    w.copy_(t)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, BatchNorm2d):
                    mod.reset_parameters()
        self._set_final_bias_prior()
        return self

    def _fused_level(self, d: torch.Tensor, lvl: Optional[int] = None
                     ) -> bool:
        b, c, h, w = d.shape
        if self._routing_batch is not None:
            b = self._routing_batch
        fused = (self.fuse == "kernel" and not self.training
                 and not self.use_attention
                 and c >= self.fuse_min_cin
                 and b * h * w >= self.fuse_min_work
                 and h % min(32, h) == 0 and w % min(32, w) == 0)
        if fused and self._routing_batch is not None:
            self._routed_levels.add(lvl)
        return fused

    @contextlib.contextmanager
    def routing_at_batch(self, batch: int):
        """For ``torch.export`` with a symbolic batch: while entered,
        ``_fused_level`` decides each level at ``batch`` in place of the
        input's batch (so tracing adds no guard on it), and the levels it
        fuses are collected in the set it yields."""
        self._routing_batch, self._routed_levels = int(batch), set()
        try:
            yield self._routed_levels
        finally:
            self._routing_batch = None

    def forward(self, x: torch.Tensor, return_features: bool = False):
        x1, x2, x3, x4, x5 = self._encoder_features(self, x)
        d = x5
        for lvl, skip in zip((4, 3, 2, 1), (x4, x3, x2, x1)):
            upconv = getattr(self, f"upconv{lvl}")
            up_h, up_w = 2 * d.shape[2], 2 * d.shape[3]
            if lvl == 1 and (up_h != skip.shape[2] or up_w != skip.shape[3]):
                skip = _center_crop_to(skip, up_h, up_w).contiguous(
                    memory_format=torch.channels_last)
            decoder = getattr(self, f"decoder{lvl}")
            if self.use_attention:
                d = upconv(d)
                skip_att = getattr(self, f"attention{lvl}")(
                    d, skip, fused=self.fuse_gate)
                # concat order (skip, up), as in the reference
                d = decoder(torch.cat([skip_att, d], dim=1))
                d = getattr(self, f"ch_attention{lvl}")(d)
            else:
                if self._fused_level(d, lvl):
                    cat = upconv(d, skip=skip, fused=True)
                else:
                    cat = torch.cat([skip, upconv(d)], dim=1)
                d = decoder(cat)

        if self.fuse_head and (not self.training or self.reparam_in_train):
            # upconv0 (2×2/s2 convT, Cin→16) and conv_final (1×1, 16→n)
            # have no nonlinearity between them: contract the two weights
            # into one (Cin, n, 2, 2) transposed conv, exact up to fp
            # reassociation, so the 16-channel full-resolution map is
            # never written. The contraction runs in f32 at least (float64
            # for a float64 model, whose training it is part of with
            # ``reparam_in_train``).
            dt = torch.promote_types(self.conv_final.weight.dtype,
                                     torch.float32)
            wf = self.conv_final.weight[:, :, 0, 0].to(dt)
            w = torch.einsum("ioyx,no->inyx", self.upconv0.weight.to(dt), wf)
            b = self.conv_final.bias.to(dt) + wf @ self.upconv0.bias.to(dt)
            out = F.conv_transpose2d(d, w.to(d.dtype), b.to(d.dtype),
                                     stride=2)
            out = _center_crop_to(out, x.shape[2], x.shape[3])
        else:
            d0 = _center_crop_to(self.upconv0(d), x.shape[2], x.shape[3])
            out = self.conv_final(d0)

        if return_features:
            x2_up = resize_bilinear(x2, (x3.shape[2], x3.shape[3]))
            return out, torch.cat([x2_up, x3.float()], dim=1)
        return out
