"""Attention modules for the U-Net decoder (port of
``segtpu/models/attention.py``).

``AttentionGate(fused=True)`` at inference folds the gate's three
BatchNorms into two matmul weight sets and biases and runs the whole gate
as one kernel launch (``segtpu_torch.kernels.attention_gate``). Exact up to
fp reassociation; the module tree and state_dict are the same either way.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.kernels.attention_gate import attention_gate
from segtpu_torch.kernels.fused_conv import fold_bn


def _fold(seq: nn.Sequential):
    """(weight, bias) of ``seq = [Conv2d, BatchNorm2d, ...]`` with the
    inference BatchNorm folded in, in f32."""
    conv, bn = seq[0], seq[1]
    f = lambda t: t.detach().float()
    return fold_bn(f(conv.weight), f(conv.bias), f(bn.weight), f(bn.bias),
                   f(bn.running_mean), f(bn.running_var), eps=bn.eps)


class AttentionGate(nn.Module):
    """Additive attention gate:
    psi = σ(BN(conv1x1(relu(BN(W_g·g) + BN(W_x·x))))); returns x · psi."""

    def __init__(self, f_g: int, f_l: int, f_int: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.W_g = nn.Sequential(nn.Conv2d(f_g, f_int, 1, **kw),
                                 nn.BatchNorm2d(f_int, **kw))
        self.W_x = nn.Sequential(nn.Conv2d(f_l, f_int, 1, **kw),
                                 nn.BatchNorm2d(f_int, **kw))
        self.psi = nn.Sequential(nn.Conv2d(f_int, 1, 1, **kw),
                                 nn.BatchNorm2d(1, **kw), nn.Sigmoid())

    def folded(self):
        """Kernel operands (ag (Cg,F), ax (Cx,F), bh (F,), apsi (F,),
        bpsi (1,)): ag/ax/apsi in the module's dtype, bh/bpsi in f32."""
        dt = self.W_g[0].weight.dtype
        wg, bg = _fold(self.W_g)
        wx, bx = _fold(self.W_x)
        wp, bp = _fold(self.psi)
        ag = wg[:, :, 0, 0].t().contiguous().to(dt)
        ax = wx[:, :, 0, 0].t().contiguous().to(dt)
        apsi = wp[0, :, 0, 0].contiguous().to(dt)
        return ag, ax, (bg + bx).contiguous(), apsi, bp.reshape(1)

    def forward(self, g, x, fused: bool = False):
        if fused and not self.training:
            out = attention_gate(g.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1),
                                 *self.folded())
            return out.permute(0, 3, 1, 2)
        return x * self.psi(F.relu(self.W_g(g) + self.W_x(x)))


class ChannelAttention(nn.Module):
    """SE-style channel attention with avg+max pooled descriptors."""

    def __init__(self, channels: int, reduction_ratio: int = 16, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        hidden = max(channels // reduction_ratio, 1)
        self.fc = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=False, **kw), nn.ReLU(),
            nn.Conv2d(hidden, channels, 1, bias=False, **kw))

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc(avg) + self.fc(mx))
