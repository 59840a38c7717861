"""Attention modules for the U-Net decoder (port of
``segtpu/models/attention.py``).

``AttentionGate(fused=True)`` at inference folds the gate's three
BatchNorms into two matmul weight sets and biases and runs the whole gate
as one kernel launch (``segtpu_torch.kernels.attention_gate``). Exact up to
fp reassociation; the module tree and state_dict are the same either way.
Without grad the fold is cached on the module and redone only when a
tensor it reads changed; while a CUDA graph is being captured it is never
taken from the cache, so the graph folds at every replay (a replayed
optimizer step changes the weights without bumping their version
counters), and ``invalidate_folds`` drops the cache of every gate of a
model whose weights were written that way. The kernel's weight operands take the
activations' dtype, so that under ``torch.autocast`` (f32 parameters,
bf16 activations, as flax's ``param_dtype``/``dtype``) the gate still runs
as the kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from segtpu_torch import resolve_device
from segtpu_torch.kernels._build import stream_capturing
from segtpu_torch.kernels.attention_gate import attention_gate
from segtpu_torch.kernels.fused_conv import fold_bn
from segtpu_torch.models.backbones import BatchNorm2d


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
                                 BatchNorm2d(f_int, **kw))
        self.W_x = nn.Sequential(nn.Conv2d(f_l, f_int, 1, **kw),
                                 BatchNorm2d(f_int, **kw))
        self.psi = nn.Sequential(nn.Conv2d(f_int, 1, 1, **kw),
                                 BatchNorm2d(1, **kw), nn.Sigmoid())
        self._fold_key, self._folded = None, None

        # (module, attribute) of every tensor ``fold`` reads, and each
        # BatchNorm's ``num_batches_tracked``: a train-mode forward updates
        # the running statistics without bumping their version counters,
        # but adds 1 to that counter in place
        self._fold_reads = [
            (mod, name) for seq in (self.W_g, self.W_x, self.psi)
            for mod, names in ((seq[0], ("weight", "bias")),
                               (seq[1], ("weight", "bias", "running_mean",
                                         "running_var",
                                         "num_batches_tracked")))
            for name in names]

    def folded(self, dtype=None):
        """``fold(dtype)``, cached while autograd records nothing (``no_grad``,
        ``inference_mode``): refolded only when one of the tensors it reads
        was replaced (``load_state_dict`` onto new storage, ``.to()``) or
        changed in place (``load_state_dict``, an optimizer step, a
        train-mode forward's BatchNorm statistics), or the parameters'
        dtype or device or the operands' ``dtype`` changed. With grad enabled every call folds afresh, so a fold made
        under ``inference_mode`` never enters a graph that autograd
        saves; so does every call while the stream captures a CUDA graph,
        whose replays must fold the weights of their moment. A fold is a
        few dozen small tensor ops."""
        if torch.is_grad_enabled() or stream_capturing():
            return self.fold(dtype)
        ins = [getattr(mod, name) for mod, name in self._fold_reads]
        key = (dtype, ins[0].dtype, ins[0].device,
               tuple((t._version, t.data_ptr()) for t in ins))
        if key != self._fold_key:
            self._folded, self._fold_key = self.fold(dtype), key
        return self._folded

    def invalidate_fold(self) -> None:
        """Drop the cached fold: the next ``folded`` folds afresh."""
        self._fold_key, self._folded = None, None

    def fold(self, dtype=None):
        """Kernel operands (ag (Cg,F), ax (Cx,F), bh (F,), apsi (F,),
        bpsi (1,)): ag/ax/apsi in ``dtype`` (default: the module's), bh/bpsi
        in f32."""
        dt = dtype or self.W_g[0].weight.dtype
        wg, bg = _fold(self.W_g)
        wx, bx = _fold(self.W_x)
        wp, bp = _fold(self.psi)
        ag = wg[:, :, 0, 0].t().contiguous().to(dt)
        ax = wx[:, :, 0, 0].t().contiguous().to(dt)
        apsi = wp[0, :, 0, 0].contiguous().to(dt)
        return ag, ax, (bg + bx).contiguous(), apsi, bp.reshape(1)

    def forward(self, g, x, fused: bool = False):
        if fused and not self.training:
            # the kernel takes NHWC-contiguous operands: the views of
            # channels_last g and x are, and ``contiguous`` returns them
            # as they are; it copies only a tensor whose layout is not
            # channels_last (a 1×1 map, or ``torch.export``'s trace, whose
            # meta strides of a transposed conv's output may be NCHW where
            # the card's are not)
            out = attention_gate(g.permute(0, 2, 3, 1).contiguous(),
                                 x.permute(0, 2, 3, 1).contiguous(),
                                 *self.folded(x.dtype))
            return out.permute(0, 3, 1, 2)
        return x * self.psi(F.relu(self.W_g(g) + self.W_x(x)))


def invalidate_folds(model: nn.Module) -> nn.Module:
    """Drop the cached fold of every ``AttentionGate`` in ``model``: for
    weights written where their version counters do not move (a replayed
    CUDA graph)."""
    for mod in model.modules():
        if isinstance(mod, AttentionGate):
            mod.invalidate_fold()
    return model


class ChannelAttention(nn.Module):
    """SE-style channel attention with avg+max pooled descriptors. On row
    bands (``bands`` set) both descriptors pool the whole image: the
    bands' sums over the global H·W, and their global maximum."""
    bands = None

    def __init__(self, channels: int, reduction_ratio: int = 16, *,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        hidden = max(channels // reduction_ratio, 1)
        self.fc = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=False, **kw), nn.ReLU(),
            nn.Conv2d(hidden, channels, 1, bias=False, **kw))

    def forward(self, x):
        if self.bands is None:
            avg = x.mean(dim=(2, 3), keepdim=True)
            mx = x.amax(dim=(2, 3), keepdim=True)
        else:
            avg, mx = self.bands.mean(x), self.bands.amax(x)
        return x * torch.sigmoid(self.fc(avg) + self.fc(mx))
