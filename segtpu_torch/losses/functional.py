"""The 16 segmentation losses on tensors (port of
``segtpu/losses/functional.py``).

Same formulas and defaults as the JAX package (the reference's
``losses.py:13-342``). Every loss takes ``(logits, targets)``: raw model
outputs and binary float targets. Most flatten, so any layout does; the
spatial ones (``boundary``, ``distance_map_bce``, ``hausdorff``) take the
port's NCHW ``(B, C, H, W)``, where the JAX package takes NHWC. The EDT
losses use the exact on-device EDT (``segtpu_torch/ops/edt.py``), their
distance maps detached as ``jax.lax.stop_gradient`` leaves them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from segtpu_torch.ops.edt import distance_transform_edt


def _bce_with_logits(logits, targets):
    """Numerically stable elementwise BCE-with-logits."""
    return (F.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def dice_loss(logits, targets, smooth: float = 1.0):
    """DiceLoss: flattens across the whole batch."""
    pred = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    intersection = torch.sum(pred * t)
    union = torch.sum(pred) + torch.sum(t)
    return 1.0 - (2.0 * intersection + smooth) / (union + smooth)


def bce_loss(logits, targets):
    return torch.mean(_bce_with_logits(logits, targets))


def weighted_bce_loss(logits, targets, beta: float = 1.0):
    weights = targets * beta + (1.0 - targets)
    return torch.mean(_bce_with_logits(logits, targets) * weights)


def balanced_bce_loss(logits, targets):
    """beta = 1 − the batch's foreground ratio."""
    beta = 1.0 - torch.sum(targets) / targets.numel()
    weights = targets * beta + (1.0 - targets) * (1.0 - beta)
    return torch.mean(_bce_with_logits(logits, targets) * weights)


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "mean"):
    bce = _bce_with_logits(logits, targets)
    fl = alpha * (1.0 - torch.exp(-bce)) ** gamma * bce
    if reduction == "mean":
        return torch.mean(fl)
    if reduction == "sum":
        return torch.sum(fl)
    return fl


def tversky_loss(logits, targets, alpha: float = 0.5, beta: float = 0.5,
                 smooth: float = 1.0):
    pred = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    tp = torch.sum(pred * t)
    fp = torch.sum((1.0 - t) * pred)
    fn = torch.sum(t * (1.0 - pred))
    return 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def focal_tversky_loss(logits, targets, alpha: float = 0.5, beta: float = 0.5,
                       gamma: float = 1.0, smooth: float = 1.0):
    return tversky_loss(logits, targets, alpha=alpha, beta=beta,
                        smooth=smooth) ** gamma


def sensitivity_specificity_loss(logits, targets, w: float = 0.5,
                                 smooth: float = 1e-7):
    pred = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    tp = torch.sum(pred * t)
    tn = torch.sum((1.0 - pred) * (1.0 - t))
    fp = torch.sum((1.0 - t) * pred)
    fn = torch.sum(t * (1.0 - pred))
    sensitivity = tp / (tp + fn + smooth)
    specificity = tn / (tn + fp + smooth)
    return 1.0 - (w * sensitivity + (1.0 - w) * specificity)


def log_cosh_dice_loss(logits, targets, smooth: float = 1.0):
    return torch.log(torch.cosh(dice_loss(logits, targets, smooth=smooth)))


def combo_loss(logits, targets, alpha: float = 0.5, smooth: float = 1.0):
    """α·BCE + (1−α)·Dice: the registry's default."""
    return alpha * bce_loss(logits, targets) + (1.0 - alpha) * dice_loss(
        logits, targets, smooth=smooth)


def exponential_logarithmic_loss(logits, targets, w_dice: float = 0.5,
                                 w_cross: float = 0.5,
                                 gamma_dice: float = 0.3,
                                 gamma_cross: float = 0.3):
    dice = dice_loss(logits, targets)
    exp_dice = torch.mean(
        (-torch.log(torch.clamp(1.0 - dice, min=1e-7))) ** gamma_dice)
    pred = torch.sigmoid(logits)
    # BCE on probabilities; the −log is clamped again below
    ce = -(targets * torch.log(torch.clamp(pred, min=1e-38))
           + (1.0 - targets) * torch.log(torch.clamp(1.0 - pred, min=1e-38)))
    exp_cross = torch.mean(
        (-torch.log(torch.clamp(1.0 - ce, min=1e-7))) ** gamma_cross)
    return w_dice * exp_dice + w_cross * exp_cross


def distance_map_bce_loss(logits, targets, alpha: float = 1.0):
    """BCE weighted by 1 + α·(the target's EDT, normalised by its max per
    sample and channel); the map carries no gradient."""
    dist = distance_transform_edt(targets)
    mx = torch.amax(dist, dim=(2, 3), keepdim=True)
    weight = 1.0 + alpha * (dist / (mx + 1e-7)).detach()
    return torch.mean(weight * _bce_with_logits(logits, targets))


def hausdorff_loss(logits, targets, alpha: float = 2.0,
                   reduction: str = "mean"):
    """Squared error weighted by pred_dist^α + target_dist^α: the EDTs of
    the soft prediction (any nonzero pixel is foreground) and of the
    target, all-zero (b, c) slices zeroed, each normalised by its global
    max; the maps carry no gradient."""
    pred = torch.sigmoid(logits)

    def dtm(img):
        field = distance_transform_edt(img)
        nonempty = torch.amax(torch.abs(img), dim=(2, 3), keepdim=True) > 0
        field = torch.where(nonempty, field, 0.0)
        return field / (torch.max(field) + 1e-7)

    pred_dist = dtm(pred.detach())
    target_dist = dtm(targets).detach()
    hd = (pred - targets) ** 2 * (pred_dist ** alpha + target_dist ** alpha)
    if reduction == "mean":
        return torch.mean(hd)
    if reduction == "sum":
        return torch.sum(hd)
    return hd


def _gaussian_kernel(size: int, sigma: float, device=None):
    """Normalised 2-D Gaussian kernel (size, size)."""
    coords = torch.arange(size, dtype=torch.float32,
                          device=device) - (size - 1) / 2.0
    g2 = coords ** 2
    g = torch.exp(-(g2[None, :] + g2[:, None]) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _max_pool_same(x, k: int):
    """Max over a k×k window, stride 1, padding k//2, on NCHW."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


def boundary_loss(logits, targets, theta0: int = 3, theta: int = 5):
    """BCE weighted by 1 + 10·(the target's morphological boundary,
    dilation − erosion, Gaussian-smoothed per channel). NCHW."""
    t = targets.to(torch.float32)
    boundary = _max_pool_same(t, theta0) + _max_pool_same(-t, theta0)
    c = t.shape[1]
    kern = _gaussian_kernel(theta, theta / 3.0, t.device)
    boundary = F.conv2d(boundary, kern.expand(c, 1, theta, theta),
                        padding=theta // 2, groups=c)
    weight = (1.0 + 10.0 * boundary).detach()
    return torch.mean(weight * _bce_with_logits(logits, targets))


def triple_combo_loss(logits, targets, alpha_dice: float = 0.33,
                      alpha_bce: float = 0.33, alpha_focal: float = 0.34,
                      focal_alpha: float = 0.25, gamma: float = 2.0,
                      smooth: float = 1.0):
    return (alpha_dice * dice_loss(logits, targets, smooth=smooth)
            + alpha_bce * bce_loss(logits, targets)
            + alpha_focal * focal_loss(logits, targets, alpha=focal_alpha,
                                       gamma=gamma))
