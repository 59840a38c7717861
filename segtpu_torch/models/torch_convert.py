"""Pretrained encoders from local torch checkpoints (port of
``segtpu/models/torch_convert.py``).

The reference builds its encoders from pretrained torchvision models and
adapts the first conv to grayscale by summing the RGB kernel
(advanced_models.py:73-139). Nothing is downloaded: the weights come from
a user-supplied local ``state_dict`` file, which this module maps onto the
port's key names:

- ``load_torchvision_encoder``: a torchvision ``resnet34``/``resnet50``/
  ``densenet121`` ``state_dict`` → the port's encoder keys (``conv1`` →
  ``input_conv`` with the RGB stem summed over its input channels,
  ``layer{i}`` → ``enc{i}``; densenet's ``features.conv0`` →
  ``input_conv``, the rest of ``features.*`` by the same name);
- ``load_reference_state``: a full reference ``UNetWithBackbone``
  ``state_dict`` (the port's own key names) → the tensors the model takes;
- ``merge_encoder`` overlays either onto a model's freshly initialised
  ``state_dict``; ``load_pretrained`` does it all for a model.

Key for key as the JAX package's converter: classifier heads
(``fc``, ``classifier``, ``features.norm5``), the reference's unused
3-channel ``features.conv0`` and every ``num_batches_tracked`` are not
read. Files are read with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from segtpu_torch.models.backbones import DENSENET_BLOCKS, RESNET_BLOCKS

_BN = ("weight", "bias", "running_mean", "running_var")
# the backbones torchvision publishes (resnet_tiny is the repo's stub)
TORCHVISION_BACKBONES = ("resnet34", "resnet50", "densenet121")

StateDict = Dict[str, torch.Tensor]


def grayscale_sum(w: torch.Tensor) -> torch.Tensor:
    """RGB first-conv (O, 3, kh, kw) → (O, 1, kh, kw) by summing over the
    input channels (advanced_models.py:76-78)."""
    return w.sum(dim=1, keepdim=True)


def _copy_bn(out: StateDict, sd: StateDict, dst: str, src: str) -> None:
    for k in _BN:
        out[f"{dst}.{k}"] = sd[f"{src}.{k}"]


def _resnet_encoder(out: StateDict, sd: StateDict, backbone: str) -> None:
    convs = ("conv1", "conv2", "conv3") if backbone == "resnet50" else \
        ("conv1", "conv2")
    _copy_bn(out, sd, "bn1", "bn1")
    for li, n in enumerate(RESNET_BLOCKS[backbone]):
        for bi in range(n):
            src, dst = f"layer{li + 1}.{bi}", f"enc{li + 1}.{bi}"
            for c in convs:
                b = c.replace("conv", "bn")
                out[f"{dst}.{c}.weight"] = sd[f"{src}.{c}.weight"]
                _copy_bn(out, sd, f"{dst}.{b}", f"{src}.{b}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample.0.weight"] = \
                    sd[f"{src}.downsample.0.weight"]
                _copy_bn(out, sd, f"{dst}.downsample.1",
                         f"{src}.downsample.1")


def _densenet_features(out: StateDict, sd: StateDict) -> None:
    """``features.norm0``, the dense blocks and the transitions, under the
    same names in both layouts."""
    _copy_bn(out, sd, "features.norm0", "features.norm0")
    for bi, n in enumerate(DENSENET_BLOCKS):
        for li in range(n):
            k = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            for c, b in (("conv1", "norm1"), ("conv2", "norm2")):
                _copy_bn(out, sd, f"{k}.{b}", f"{k}.{b}")
                out[f"{k}.{c}.weight"] = sd[f"{k}.{c}.weight"]
        if bi < len(DENSENET_BLOCKS) - 1:
            k = f"features.transition{bi + 1}"
            _copy_bn(out, sd, f"{k}.norm", f"{k}.norm")
            out[f"{k}.conv.weight"] = sd[f"{k}.conv.weight"]


def load_torchvision_encoder(sd: StateDict, backbone: str,
                             grayscale: bool = True) -> StateDict:
    """A torchvision classifier ``state_dict`` → the port's encoder
    tensors, by the port's key names. Overlay them on a model's
    ``state_dict`` with ``merge_encoder``."""
    if backbone not in TORCHVISION_BACKBONES:
        raise ValueError(f"no torchvision layout for backbone {backbone!r}; "
                         f"one of {TORCHVISION_BACKBONES}")
    stem = "features.conv0.weight" if backbone == "densenet121" else \
        "conv1.weight"
    out: StateDict = {"input_conv.weight": grayscale_sum(sd[stem])
                      if grayscale else sd[stem]}
    if backbone == "densenet121":
        _densenet_features(out, sd)
    else:
        _resnet_encoder(out, sd, backbone)
    return out


def load_reference_state(sd: StateDict, model_keys) -> StateDict:
    """A full reference ``UNetWithBackbone`` ``state_dict`` → the tensors
    of ``model_keys`` it holds: every key but ``num_batches_tracked``; a
    missing key raises ``KeyError``, except a conv's bias, which keeps the
    model's own. As in the JAX package, a densenet checkpoint without
    ``features.norm0.weight`` gives only its stem of the encoder."""
    keys = set(model_keys)
    dense_enc = "features.norm0.weight" in sd
    out: StateDict = {}
    for k in model_keys:
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("features.") and not dense_enc:
            continue
        conv_bias = (k.endswith(".bias") and k.removesuffix(".bias")
                     + ".running_mean" not in keys)
        if conv_bias and k not in sd:
            continue
        out[k] = sd[k]
    return out


def merge_encoder(model_sd: StateDict, enc_sd: StateDict) -> StateDict:
    """``model_sd`` with ``enc_sd``'s tensors laid over it (the
    ``pretrained=True`` path); every key of ``enc_sd`` must be the
    model's."""
    unknown = sorted(set(enc_sd) - set(model_sd))
    if unknown:
        raise KeyError(f"keys the model does not have: {unknown[:5]}")
    return {**model_sd, **enc_sd}


def resolve_encoder_checkpoint(ckpt, backbone: str) -> Optional[str]:
    """``config["encoder_checkpoint"]`` is either one path (used whatever
    the backbone) or a ``{backbone: path}`` mapping for multi-backbone
    grids (the model-configuration protocol trains resnet34 and resnet50,
    each from its own torchvision checkpoint). A mapping with no entry for
    this backbone resolves to None: a fresh init for that config."""
    if isinstance(ckpt, dict):
        return ckpt.get(backbone)
    return ckpt


def load_pretrained(model, generator: torch.Generator, checkpoint_path: str,
                    kind: str = "torchvision"):
    """Initialise ``model`` from ``generator`` (``reset_parameters``) and
    overlay the weights of a local ``torch.save``'d ``state_dict``.

    kind='torchvision': the encoder only, with the grayscale stem sum (the
    reference's ``pretrained=True``); kind='reference': a full reference
    ``UNetWithBackbone`` ``state_dict``. Returns ``model``."""
    if kind not in ("torchvision", "reference"):
        raise ValueError(f"kind must be 'torchvision' or 'reference'; "
                         f"got {kind!r}")
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    model.reset_parameters(generator)
    own = model.state_dict()
    enc = load_torchvision_encoder(sd, model.backbone) \
        if kind == "torchvision" else load_reference_state(sd, own)
    model.load_state_dict(merge_encoder(own, enc), strict=True)
    return model
