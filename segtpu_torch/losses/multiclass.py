"""Multi-class segmentation losses and metrics, softmax (port of
``segtpu/losses/multiclass.py``).

Targets are integer class labels, (B, H, W) or (B, 1, H, W), any numeric
dtype. Logits and probabilities are NCHW (B, C, H, W), the class on dim 1
(the JAX package: NHWC, the class last).
"""

from __future__ import annotations

from functools import partial

import torch


def _labels(targets) -> torch.Tensor:
    t = targets
    if t.dim() == 4 and t.shape[1] == 1:
        t = t[:, 0]
    return t.long()


def _one_hot(t, c, dtype):
    """(B, H, W) labels in [0, c) → (B, C, H, W) one-hot, by comparison:
    ``F.one_hot`` checks the labels' range on the host, a synchronisation
    that neither ``vmap`` nor a window of epochs with one fetch allows."""
    classes = torch.arange(c, device=t.device).view(1, c, 1, 1)
    return (t[:, None] == classes).to(dtype)


def softmax_ce_loss(logits, targets):
    """Mean softmax cross-entropy over pixels."""
    t = _labels(targets)
    picked = torch.gather(torch.log_softmax(logits, dim=1), 1, t[:, None])
    return -torch.mean(picked)


def dice_loss_mc(logits, targets, smooth: float = 1.0):
    """Macro soft-Dice over classes (softmax probabilities vs one-hot)."""
    t = _labels(targets)
    probs = torch.softmax(logits, dim=1)
    onehot = _one_hot(t, logits.shape[1], probs.dtype)
    inter = torch.sum(probs * onehot, dim=(0, 2, 3))
    union = torch.sum(probs, dim=(0, 2, 3)) + torch.sum(onehot, dim=(0, 2, 3))
    return 1.0 - torch.mean((2.0 * inter + smooth) / (union + smooth))


def combo_loss_mc(logits, targets, alpha: float = 0.5, smooth: float = 1.0):
    return alpha * softmax_ce_loss(logits, targets) + \
        (1.0 - alpha) * dice_loss_mc(logits, targets, smooth=smooth)


def focal_loss_mc(logits, targets, gamma: float = 2.0):
    """Multi-class focal loss (softmax)."""
    t = _labels(targets)
    picked = torch.gather(torch.log_softmax(logits, dim=1), 1, t[:, None])
    return -torch.mean((1.0 - torch.exp(picked)) ** gamma * picked)


def get_multiclass_loss(config):
    """``get_loss_function``'s counterpart for n_classes > 1; keys reuse
    the binary names where the concept carries over."""
    config = config or {}
    name = config.get("loss_fn", "combo")
    table = {
        "ce": lambda: softmax_ce_loss,
        "bce": lambda: softmax_ce_loss,   # closest analog
        "dice": lambda: partial(dice_loss_mc,
                                smooth=config.get("smooth", 1.0)),
        "combo": lambda: partial(combo_loss_mc,
                                 alpha=config.get("loss_alpha", 0.5)),
        "focal": lambda: partial(focal_loss_mc,
                                 gamma=config.get("focal_gamma", 2.0)),
    }
    if name in table:
        fn = table[name]()
        fn.name = name
        return fn
    print(f"Warning: no multiclass '{name}', defaulting to combo")
    return partial(combo_loss_mc, alpha=config.get("loss_alpha", 0.5))


def calculate_metrics_multiclass(probs, targets):
    """Macro-averaged confusion metrics from softmax probabilities (B, C,
    H, W): the binary ``calculate_metrics``'s keys, 'iou' the macro mean
    IoU over classes."""
    t = _labels(targets)
    c = probs.shape[1]
    eps = 1e-7
    pred_oh = _one_hot(torch.argmax(probs, dim=1), c, torch.float32)
    t_oh = _one_hot(t, c, torch.float32)
    axes = (0, 2, 3)
    tp = torch.sum(pred_oh * t_oh, dim=axes)
    fp = torch.sum(pred_oh * (1 - t_oh), dim=axes)
    fn = torch.sum((1 - pred_oh) * t_oh, dim=axes)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    iou = tp / (tp + fp + fn + eps)
    accuracy = torch.mean((torch.argmax(probs, dim=1) == t).float())
    return {
        "precision": torch.mean(precision),
        "recall": torch.mean(recall),
        "f1": torch.mean(f1),
        "iou": torch.mean(iou),
        "accuracy": accuracy,
    }
