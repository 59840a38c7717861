"""The control's precision: float8 operands, one scale per tensor, as
fp8 training recipes compute (e4m3 forward, e5m2 gradients).

The configurations compute in bfloat16; the next precision down that a
later change might be tempted by is 8-bit floating point.
``quantize_e4m3`` rounds a tensor to e4m3 at the scale that maps its
largest magnitude to e4m3's largest finite value (448) and returns it in
its own dtype; its gradient is the incoming gradient rounded to e5m2 the
same way (largest finite value 57344). ``UNet.set_quantize(quantize_e4m3)``
puts it on every convolution's input and weight, so a convolution's
forward products take e4m3 operands and the gradients that reach its
input and weight are e5m2.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t.detach().float() * scale).to(dtype).float() / scale) \
        .to(t.dtype)


class _Quantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def quantize_e4m3(t: torch.Tensor) -> torch.Tensor:
    return _Quantize.apply(t)
