"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version and a launch count (``<wrapper>.launches``), plus the helpers that
read and reset the counts."""

from __future__ import annotations

from typing import Dict

from segtpu_torch.kernels.attention_gate import attention_gate
from segtpu_torch.kernels.fused_block import conv_pair_bn_relu
from segtpu_torch.kernels.fused_conv import conv3x3_bn_relu, upsample2x_concat

WRAPPERS = {"attention_gate": attention_gate,
            "upsample2x_concat": upsample2x_concat,
            "conv3x3_bn_relu": conv3x3_bn_relu,
            "conv_pair_bn_relu": conv_pair_bn_relu}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
