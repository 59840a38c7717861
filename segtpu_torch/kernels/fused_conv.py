"""Decoder kernels: the fused 3×3 conv + BN + ReLU and the fused 2×
upsample + skip concat (wrappers, plain versions and launch counts of
``csrc/conv3x3_bn_relu.cu`` and ``csrc/upsample2x_concat.cu``), and the
plain inference-BatchNorm fold.

Replaces ``segtpu/kernels/fused_conv.py::conv3x3_bn_relu_pallas`` and
``::upsample2x_concat_pallas``. The source note in each ``.cu`` file says
what bounds the kernel on an H100 and what its design does about it. No
model path runs the conv kernel: the JAX package reaches it only from its
kernel bench, whose counterpart is ``segtpu_torch.tools.kernel_bench``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from segtpu_torch.kernels import _build
from segtpu_torch.kernels._build import DTYPE_CODES


def upsample2x_concat_plain(x, wv, b, skip):
    """``concat([skip, conv_transpose2x2/s2(x) + b])`` as plain PyTorch,
    products in f32, NHWC in and out (``F.conv_transpose2d`` +
    ``torch.cat``). ``wv`` is the (Cin,2,2,Co) NHWC view of a torch
    ConvTranspose2d weight (Cin,Co,2,2)."""
    f32 = torch.float32
    up = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(f32),
                            wv.permute(0, 3, 1, 2).to(f32), b.to(f32),
                            stride=2)
    cat = torch.cat([skip.permute(0, 3, 1, 2), up.to(skip.dtype)], dim=1)
    return cat.permute(0, 2, 3, 1).contiguous()


def _check(x, wv, b, skip):
    for name, t in (("x", x), ("wv", wv), ("skip", skip)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"upsample2x_concat: {name} must be an NHWC-contiguous 4-D "
                "tensor (the permute(0,2,3,1) view of a channels_last "
                f"tensor); got shape {tuple(t.shape)}, strides {t.stride()}")
    bsz, h, w, cin = x.shape
    co = wv.shape[-1]
    if tuple(wv.shape) != (cin, 2, 2, co):
        raise ValueError(f"upsample2x_concat: wv must be (Cin,2,2,Co) = "
                         f"({cin},2,2,Co); got {tuple(wv.shape)}")
    if tuple(skip.shape[:3]) != (bsz, 2 * h, 2 * w):
        raise ValueError(f"upsample2x_concat: skip {tuple(skip.shape)} is "
                         f"not (B,2H,2W,Cs) for x {tuple(x.shape)}")
    if tuple(b.shape) != (co,) or not b.is_contiguous():
        raise ValueError(f"upsample2x_concat: bias must be a contiguous "
                         f"({co},) tensor; got {tuple(b.shape)}")
    if any(t.device != x.device for t in (wv, b, skip)):
        raise ValueError("upsample2x_concat: tensors on different devices")
    if x.dtype not in DTYPE_CODES or wv.dtype != x.dtype \
            or skip.dtype != x.dtype:
        raise TypeError("upsample2x_concat: x, wv and skip must share one "
                        "dtype of float32/bfloat16")
    if b.dtype != torch.float32:
        raise TypeError("upsample2x_concat: bias must be float32")


# C signature of upsample2x_concat_launch: dtype, x, wv, bias, skip, out,
# batch, h, w, cin, co, cs, stream
UPSAMPLE_ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 5
                     + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


def upsample2x_concat(x, wv, b, skip):
    """Fused ConvTranspose(2×2, stride 2) of x + channel concat with skip.

    x (B,H,W,Cin), wv (Cin,2,2,Co) and skip (B,2H,2W,Cs), all
    NHWC-contiguous in one dtype; b (Co,) float32. Returns
    (B,2H,2W,Cs+Co), channels ordered [skip, up]. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (and counts the
    launch) or raises.
    """
    _check(x, wv, b, skip)
    if x.device.type == "cpu":
        return upsample2x_concat_plain(x, wv, b, skip)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_concat: unsupported device {x.device}")
    bsz, h, w, cin = x.shape
    co, cs = wv.shape[-1], skip.shape[-1]
    out = torch.empty((bsz, 2 * h, 2 * w, cs + co), dtype=x.dtype,
                      device=x.device)
    fn = _build.launcher("upsample2x_concat", UPSAMPLE_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPE_CODES[x.dtype], x.data_ptr(), wv.data_ptr(),
                  b.data_ptr(), skip.data_ptr(), out.data_ptr(),
                  bsz, h, w, cin, co, cs, stream)
    _build.check("upsample2x_concat", code)
    upsample2x_concat.launches += 1
    return out


upsample2x_concat.launches = 0


def conv3x3_bn_relu_plain(x, w, scale, bias):
    """``relu(conv3x3_same(x, w) · scale + bias)`` as plain PyTorch:
    ``F.conv2d`` in f32 on the NCHW views, the affine and ReLU in f32, one
    cast to x's dtype (``conv3x3_bn_relu_xla``). x (B,H,W,Cin) NHWC, w
    (3,3,Cin,Cout) HWIO; returns (B,H,W,Cout) NHWC-contiguous."""
    f32 = torch.float32
    y = F.conv2d(x.permute(0, 3, 1, 2).to(f32),
                 w.permute(3, 2, 0, 1).to(f32), padding=1)
    y = torch.relu(y * scale.to(f32)[:, None, None]
                   + bias.to(f32)[:, None, None])
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def check_conv_chain(op: str, x, convs) -> None:
    """The checks shared by the conv kernels' wrappers. x must be an
    NHWC-contiguous float32/bfloat16 tensor; ``convs`` lists each conv as
    ``((name, w), (name, scale), (name, bias))``: w a contiguous HWIO
    (3,3,Cin,Cout) weight in x's dtype whose Cin is x's channels for the
    first conv and the previous Cout after it; scale and bias contiguous
    float32 (Cout,); everything on x's device."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"{op}: x must be an NHWC-contiguous 4-D tensor (the "
            "permute(0,2,3,1) view of a channels_last tensor); got shape "
            f"{tuple(x.shape)}, strides {x.stride()}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{op}: x must be float32 or bfloat16; got {x.dtype}")
    cin = x.shape[-1]
    for (wn, w), (sn, scale), (bn, bias) in convs:
        if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin) \
                or not w.is_contiguous():
            raise ValueError(f"{op}: {wn} must be a contiguous HWIO "
                             f"(3,3,{cin},Cout) tensor; got "
                             f"{tuple(w.shape)}")
        if w.dtype != x.dtype:
            raise TypeError(f"{op}: {wn} is {w.dtype}, x is {x.dtype}")
        cin = w.shape[-1]
        for name, t in ((sn, scale), (bn, bias)):
            if tuple(t.shape) != (cin,) or not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be a contiguous "
                                 f"({cin},) tensor; got {tuple(t.shape)}")
            if t.dtype != torch.float32:
                raise TypeError(f"{op}: {name} must be float32; got "
                                f"{t.dtype}")
        if any(t.device != x.device for t in (w, scale, bias)):
            raise ValueError(f"{op}: {wn}, {sn} and {bn} must be on x's "
                             f"device {x.device}")


# C signature of conv3x3_bn_relu_launch: dtype, x, w, scale, bias, out,
# batch, h, w, cin, cout, stream
CONV3X3_ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 5
                    + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def conv3x3_bn_relu(x, w, scale, bias, *, tile: int = 64):
    """Fused 3×3 'same' conv + per-channel scale/bias (folded inference
    BatchNorm) + ReLU, one kernel launch.

    x (B,H,W,Cin) NHWC-contiguous, w (3,3,Cin,Cout) HWIO in x's dtype
    (float32 or bfloat16); scale and bias (Cout,) float32. Returns
    (B,H,W,Cout) in x's dtype. ``tile`` is the JAX kernel's spatial tile,
    kept so the two signatures match; this kernel picks its own tiling: in
    bf16, a tensor-core product from a haloed window staged once per chunk
    of input channels, 16×32 output pixels × 64 channels on ``wgmma``
    above Cout = 32 and 16×16 × 32 on ``mma.sync`` up to it, bounded on
    the card by the products' issue rate (one block per SM, no producer
    warp); in f32, flat pixel tiles on the CUDA cores. It masks its own
    ragged edge, so H and W need not divide by anything. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch) or raises.
    """
    check_conv_chain("conv3x3_bn_relu", x,
                     [(("w", w), ("scale", scale), ("bias", bias))])
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu: unsupported device {x.device}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    fn = _build.launcher("conv3x3_bn_relu", CONV3X3_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                  scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  bsz, h, wd, cin, cout, stream)
    _build.check("conv3x3_bn_relu", code)
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0


def fold_bn(weight, bias, bn_weight, bn_bias, bn_mean, bn_var,
            eps: float = 1e-5):
    """Fold inference BatchNorm into a conv's weight (O, ...) and bias:
    BN(conv(x) + b) = conv_{w·s}(x) + (b − mean)·s + shift, with
    s = bn_weight/√(var + eps) per output channel. Returns (w', b')."""
    s = bn_weight / torch.sqrt(bn_var + eps)
    return (weight * s.reshape((-1,) + (1,) * (weight.dim() - 1)),
            (bias - bn_mean) * s + bn_bias)
