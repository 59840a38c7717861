"""Models of the port: ResNet encoders, attention modules, the U-Net, and
the JAX-to-port weight converter."""

from segtpu_torch.models.unet import UNetWithBackbone

__all__ = ["UNetWithBackbone"]
