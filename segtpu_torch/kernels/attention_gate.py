"""Fused additive attention gate (inference path): wrapper, plain version
and launch count of the CUDA kernel in ``csrc/attention_gate.cu``.

    out = x · σ( relu(g·Ag + x·Ax + b_h) · a_psi + b_psi )

computed per pixel row of the NHWC tensors g (B,H,W,Cg) and x (B,H,W,Cx),
reading g and x once and writing only ``out``. The three inference
BatchNorms are folded into (Ag, Ax, b_h, a_psi, b_psi) by the caller
(``segtpu_torch.models.attention.AttentionGate.folded``).

Replaces ``segtpu/kernels/attention_gate.py::attention_gate_fused``. The
source note in the ``.cu`` file says what bounds the kernel on an H100
and what its design does about it.
"""

from __future__ import annotations

import ctypes

import torch

from segtpu_torch.kernels import _build
from segtpu_torch.kernels._build import DTYPE_CODES


def attention_gate_plain(g, x, ag, ax, bh, apsi, bpsi):
    """The gate as plain PyTorch, in f32 (the jnp composition at
    ``segtpu/kernels/attention_gate.py:95-99``); returns x's dtype."""
    f32 = torch.float32
    h = torch.relu(g.to(f32) @ ag.to(f32) + x.to(f32) @ ax.to(f32)
                   + bh.to(f32))
    p = h @ apsi.to(f32) + bpsi.to(f32)
    return (x.to(f32) * torch.sigmoid(p)[..., None]).to(x.dtype)


def _check(g, x, ag, ax, bh, apsi, bpsi):
    for name, t in (("g", g), ("x", x)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"attention_gate: {name} must be an NHWC-contiguous "
                "(B,H,W,C) tensor (the permute(0,2,3,1) view of a "
                f"channels_last tensor); got shape {tuple(t.shape)}, "
                f"strides {t.stride()}")
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"attention_gate: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} differ in (B,H,W)")
    cg, cx, f = g.shape[-1], x.shape[-1], ag.shape[-1]
    want = {"ag": (ag, (cg, f)), "ax": (ax, (cx, f)), "bh": (bh, (f,)),
            "apsi": (apsi, (f,)), "bpsi": (bpsi, (1,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"attention_gate: {name} must be a contiguous "
                             f"{shape} tensor; got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"attention_gate: {name} is on {t.device}, "
                             f"x on {x.device}")
    if x.dtype not in DTYPE_CODES or any(
            t.dtype != x.dtype for t in (g, ag, ax, apsi)):
        raise TypeError("attention_gate: g, x, ag, ax and apsi must share "
                        "one dtype of float32/bfloat16")
    if bh.dtype != torch.float32 or bpsi.dtype != torch.float32:
        raise TypeError("attention_gate: bh and bpsi must be float32")


# C signature of attention_gate_launch: dtype, g, x, ag, ax, bh, apsi,
# bpsi, out, m, cg, cx, f, stream
ARGTYPES = ((ctypes.c_int,) + (ctypes.c_void_p,) * 8
            + (ctypes.c_longlong,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def attention_gate(g, x, ag, ax, bh, apsi, bpsi):
    """x · σ(relu(g·Ag + x·Ax + bh)·apsi + bpsi), one fused pass.

    g (B,H,W,Cg), x (B,H,W,Cx) NHWC-contiguous; ag (Cg,F), ax (Cx,F) and
    apsi (F,) in x's dtype; bh (F,) and bpsi (1,) float32. Returns
    (B,H,W,Cx) in x's dtype. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (and counts the launch) or raises.
    """
    _check(g, x, ag, ax, bh, apsi, bpsi)
    if x.device.type == "cpu":
        return attention_gate_plain(g, x, ag, ax, bh, apsi, bpsi)
    if x.device.type != "cuda":
        raise ValueError(f"attention_gate: unsupported device {x.device}")
    out = torch.empty_like(x)
    fn = _build.launcher("attention_gate", ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(DTYPE_CODES[x.dtype], g.data_ptr(), x.data_ptr(),
                  ag.data_ptr(), ax.data_ptr(), bh.data_ptr(),
                  apsi.data_ptr(), bpsi.data_ptr(), out.data_ptr(),
                  x.numel() // x.shape[-1], g.shape[-1], x.shape[-1],
                  ag.shape[-1], stream)
    _build.check("attention_gate", code)
    attention_gate.launches += 1
    return out


attention_gate.launches = 0
