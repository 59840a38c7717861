"""The yardstick's arithmetic: the H100's published peaks, a kernel's
least time, the attention gate's and the upsample+concat's bytes and
operations, the kinds of device kernels, and the model FLOPs of one
forward.

The first four are frozen copies with their provenance, so that a later
change to the program cannot move the yardstick:

- ``HBM_BYTES_PER_S``, ``PEAK_OPS`` and ``bound``: ``chip_smoke.py:290-291``
  and ``chip_smoke.py:419`` (commit c6ecb5c);
- ``gate_bytes_ops``: ``chip_smoke.py:507-508`` (``_gate_case``);
- ``upsample_bytes_ops``: ``chip_smoke.py:535-537`` (``_upsample_case``);
- ``PORT_KERNELS`` and ``kernel_kind``:
  ``segtpu_torch/core/hlo_profile.py:51-54`` and ``:118-140``.

``forward_macs`` counts the multiply-accumulates of the reference model's
convolutions (``reference/unet.py``) at the configuration's shapes, on
the meta device: the resnet stem counts as the 7×7 convolution whatever
form the program runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# H100 SXM, NVIDIA's data sheet: HBM3 bytes/s, dense operations/s by input
# type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BF16 = PEAK_OPS[torch.bfloat16]

_ELEMENT_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def bound(nbytes: float, ops: float, dtype) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gate_bytes_ops(m: int, cg: int, cx: int, f: int, dtype
                   ) -> Tuple[int, int]:
    """One fused attention gate over ``m`` pixels: g (m, Cg) and x (m, Cx)
    read, x·psi (m, Cx) written, the folded weights (Cg + Cx + 1, F) in the
    working type and the f32 biases (F + 1) read once; the two products,
    the bias, ReLU and psi's dot product, and the final scaling."""
    es = _ELEMENT_BYTES[dtype]
    nbytes = es * (m * (cg + 2 * cx) + (cg + cx + 1) * f) + 4 * (f + 1)
    ops = 2 * m * f * (cg + cx) + 3 * m * f + m * cx
    return nbytes, ops


def upsample_bytes_ops(m: int, cin: int, co: int, cs: int, dtype
                       ) -> Tuple[int, int]:
    """One fused 2×2/s2 transposed convolution + concat over ``m`` input
    pixels: x (m, Cin) and skip (4m, Cs) read, the (4m, Cs + Co) output
    written, the weights (Cin, 4·Co) read once and the f32 bias (Co); the
    product and the bias."""
    es = _ELEMENT_BYTES[dtype]
    nbytes = es * (m * cin + 4 * m * cs + 4 * m * (cs + co)
                   + cin * 4 * co) + 4 * co
    ops = 2 * m * cin * 4 * co + 4 * m * co
    return nbytes, ops


# the port's kernels by the names the profiler shows: every ``__global__``
# function of ``segtpu_torch/csrc/*.cu``, the gate's two first
PORT_KERNELS = ("gate_bf16_kernel", "attention_gate_kernel",
                "upsample_bf16_kernel", "upsample2x_concat_kernel",
                "conv_wgmma_kernel", "conv_bf16_kernel", "conv_f32_kernel",
                "pair_wgmma_kernel", "pair_bf16_kernel", "pair_f32_kernel")
GATE_KERNELS = PORT_KERNELS[:2]
UPSAMPLE_KERNELS = PORT_KERNELS[2:4]


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name."""
    n = name.lower()
    if "nccl" in n:
        return "collective"
    if any(k in name for k in PORT_KERNELS):
        return "port_kernel"
    if "dgrad" in n:
        return "conv_dgrad"
    if "wgrad" in n:
        return "conv_wgrad"
    if "batch_norm" in n or "batchnorm" in n or "bn_fw" in n \
            or "bn_bw" in n:
        return "batchnorm"
    if ("conv" in n or "implicit" in n or "fprop" in n
            or "xmma" in n or "cudnn" in n):
        return "conv_fwd"
    if "gemm" in n or "sm90_" in n or "cutlass" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def forward_macs(model_cfg: Dict, image_size: int) -> int:
    """Multiply-accumulates of one image's forward through the reference
    model of ``model_cfg`` at ``image_size``²: every convolution and
    transposed convolution (the gates' and the channel attention's 1×1
    ones included), counted from the shapes on the meta device."""
    from portbench.reference.unet import UNet
    with torch.device("meta"):
        model = UNet(model_cfg["backbone"], model_cfg["use_attention"],
                     model_cfg["n_classes"]).eval()
    total = 0

    def conv_hook(mod, inp, out):
        nonlocal total
        w = mod.weight
        if isinstance(mod, torch.nn.ConvTranspose2d):
            # each input pixel meets every (Cout, kh, kw) weight of its Cin
            total += inp[0].numel() * w.shape[1] * w.shape[2] * w.shape[3]
        else:
            total += out.numel() * (w.shape[1] * w.shape[2] * w.shape[3])

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(torch.empty(1, 1, image_size, image_size, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total
