"""Decoder kernels: the fused 2× upsample + skip concat (wrapper, plain
version and launch count of ``csrc/upsample2x_concat.cu``) and the plain
inference-BatchNorm fold.

Replaces ``segtpu/kernels/fused_conv.py::upsample2x_concat_pallas``. The
source note in the ``.cu`` file says what bounds the kernel on an H100 and
what its design does about it. ``conv3x3_bn_relu_pallas`` of the same
JAX module is not on the port's path yet (ROADMAP queue B).
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


def _launcher():
    fn = _build.load("upsample2x_concat").upsample2x_concat_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPE_CODES[x.dtype], x.data_ptr(), wv.data_ptr(),
                  b.data_ptr(), skip.data_ptr(), out.data_ptr(),
                  bsz, h, w, cin, co, cs, stream)
    _build.check("upsample2x_concat", code)
    upsample2x_concat.launches += 1
    return out


upsample2x_concat.launches = 0


def fold_bn(weight, bias, bn_weight, bn_bias, bn_mean, bn_var,
            eps: float = 1e-5):
    """Fold inference BatchNorm into a conv's weight (O, ...) and bias:
    BN(conv(x) + b) = conv_{w·s}(x) + (b − mean)·s + shift, with
    s = bn_weight/√(var + eps) per output channel. Returns (w', b')."""
    s = bn_weight / torch.sqrt(bn_var + eps)
    return (weight * s.reshape((-1,) + (1,) * (weight.dim() - 1)),
            (bias - bn_mean) * s + bn_bias)
