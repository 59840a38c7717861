"""String-keyed loss registry with per-loss hyperparameters from config
(port of ``segtpu/losses/registry.py``).

Same keys, config hyperparameter names and defaults as the JAX package
(the reference's ``losses.py:345-403``), and the same fallback: an unknown
name warns and gives the combo loss. ``get_loss_function`` returns a
callable ``loss(logits, targets)`` on tensors.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

from segtpu_torch.losses import functional as F


def _named(fn: Callable, name: str) -> Callable:
    fn.name = name
    return fn


def get_loss_function(config: Dict) -> Callable:
    """Initialize the appropriate loss function based on config
    (losses.py:345-403)."""
    config = config or {}
    loss_name = config.get("loss_fn", "combo")

    loss_functions = {
        "dice": lambda: partial(F.dice_loss, smooth=config.get("smooth", 1.0)),
        "bce": lambda: F.bce_loss,
        "weighted_bce": lambda: partial(
            F.weighted_bce_loss, beta=config.get("beta", 2.0)),
        "balanced_bce": lambda: F.balanced_bce_loss,
        "focal": lambda: partial(
            F.focal_loss,
            alpha=config.get("focal_alpha", 0.25),
            gamma=config.get("focal_gamma", 2.0)),
        "combo": lambda: partial(
            F.combo_loss, alpha=config.get("loss_alpha", 0.5)),
        "triple_combo": lambda: partial(
            F.triple_combo_loss,
            alpha_dice=config.get("alpha_dice", 0.33),
            alpha_bce=config.get("alpha_bce", 0.33),
            alpha_focal=config.get("alpha_focal", 0.34),
            focal_alpha=config.get("focal_alpha", 0.25),
            gamma=config.get("focal_gamma", 2.0)),
        "tversky": lambda: partial(
            F.tversky_loss,
            alpha=config.get("tversky_alpha", 0.5),
            beta=config.get("tversky_beta", 0.5)),
        "tversky_balanced": lambda: partial(F.tversky_loss, alpha=0.5, beta=0.5),
        "tversky_recall": lambda: partial(F.tversky_loss, alpha=0.3, beta=0.7),
        "focal_tversky": lambda: partial(
            F.focal_tversky_loss,
            alpha=config.get("tversky_alpha", 0.5),
            beta=config.get("tversky_beta", 0.5),
            gamma=config.get("focal_tversky_gamma", 0.75)),
        "sensitivity_specificity": lambda: partial(
            F.sensitivity_specificity_loss,
            w=config.get("sensitivity_weight", 0.5)),
        "log_cosh_dice": lambda: partial(
            F.log_cosh_dice_loss, smooth=config.get("smooth", 1.0)),
        "exponential_logarithmic": lambda: partial(
            F.exponential_logarithmic_loss,
            w_dice=config.get("w_dice", 0.5),
            w_cross=config.get("w_cross", 0.5),
            gamma_dice=config.get("gamma_dice", 0.3),
            gamma_cross=config.get("gamma_cross", 0.3)),
        "distance_map_bce": lambda: partial(
            F.distance_map_bce_loss, alpha=config.get("distance_alpha", 1.0)),
        "hausdorff": lambda: partial(
            F.hausdorff_loss, alpha=config.get("hausdorff_alpha", 2.0)),
        "boundary": lambda: partial(
            F.boundary_loss,
            theta0=config.get("boundary_theta0", 3),
            theta=config.get("boundary_theta", 5)),
    }

    if loss_name in loss_functions:
        return _named(loss_functions[loss_name](), loss_name)
    print(f"Warning: Unknown loss function '{loss_name}', defaulting to ComboLoss")
    return _named(partial(F.combo_loss, alpha=config.get("loss_alpha", 0.5)), "combo")


def available_losses():
    """Registry keys (losses.py:485-490 plus the tversky presets)."""
    return [
        "dice", "bce", "weighted_bce", "balanced_bce", "focal",
        "tversky", "tversky_balanced", "tversky_recall", "focal_tversky",
        "sensitivity_specificity", "log_cosh_dice", "combo", "triple_combo",
        "exponential_logarithmic", "distance_map_bce", "hausdorff", "boundary",
    ]


# Full selection guide (capability parity with the reference's
# LOSS_FUNCTION_GUIDE, losses.py:407-480), extended with each loss's
# registry key and config hyperparameter names so it doubles as API docs.
LOSS_FUNCTION_GUIDE = """
Loss Function Selection Guide:
=============================

1. Binary Cross-Entropy — key 'bce':
   - Use for: balanced datasets; a general-purpose starting point
   - Pros: stable training, well-understood behavior
   - Cons: degrades when foreground/background are imbalanced

2. Weighted BCE — key 'weighted_bce' (config: beta, default 2.0):
   - Use for: skewed datasets (far more background than foreground)
   - Pros: handles mild imbalance with one knob
   - Cons: beta needs tuning per dataset

3. Balanced BCE — key 'balanced_bce':
   - Use for: class imbalance without manual weight tuning
   - Pros: weights derive automatically from each batch's fg ratio
   - Cons: can still struggle under extreme imbalance

4. Focal Loss — key 'focal' (config: focal_alpha 0.25, focal_gamma 2.0):
   - Use for: highly imbalanced data, hard-to-classify pixels
   - Pros: down-weights easy pixels, concentrates on hard ones
   - Cons: two extra hyperparameters to tune

5. Dice Loss — key 'dice' (config: smooth, default 1.0):
   - Use for: segmentation under class imbalance
   - Pros: directly optimizes an IoU-like overlap metric
   - Cons: can be unstable with very small objects

6. Tversky Loss — key 'tversky' (config: tversky_alpha 0.5,
   tversky_beta 0.5; presets 'tversky_balanced' 0.5/0.5 and
   'tversky_recall' 0.3/0.7):
   - Use for: explicit control of the FP/FN trade-off
   - Pros: alpha weights false positives, beta false negatives
   - Cons: the trade-off needs careful tuning

7. Focal Tversky — key 'focal_tversky' (config: tversky_alpha,
   tversky_beta, focal_tversky_gamma 0.75):
   - Use for: small regions of interest with high imbalance
   - Pros: combines focal's hard-example focus with Tversky's trade-off
   - Cons: three hyperparameters interact

8. Sensitivity-Specificity — key 'sensitivity_specificity'
   (config: sensitivity_weight, default 0.5):
   - Use for: medical imaging where the TP/TN balance matters
   - Pros: direct control over sensitivity vs specificity
   - Cons: does not directly optimize overall accuracy

9. Log-Cosh Dice — key 'log_cosh_dice' (config: smooth 1.0):
   - Use for: smoother optimization of the Dice coefficient
   - Pros: log-cosh tames Dice's gradient spikes
   - Cons: optimum differs slightly from pure Dice

10. Combo (Dice + BCE) — key 'combo' (config: loss_alpha 0.5;
    the registry default and the unknown-name fallback):
    - Use for: general purpose; the balanced default
    - Pros: region overlap (Dice) plus per-pixel calibration (BCE)
    - Cons: one blending hyperparameter (alpha)

11. Triple Combo (Dice + BCE + Focal) — key 'triple_combo'
    (config: alpha_dice 0.33, alpha_bce 0.33, alpha_focal 0.34):
    - Use for: imbalanced data where combo alone plateaus
    - Pros: adds focal's hard-pixel emphasis to the combo blend
    - Cons: most hyperparameters of any registry entry

12. Exponential Logarithmic — key 'exponential_logarithmic'
    (config: w_dice 0.5, w_cross 0.5, gamma_dice 0.3, gamma_cross 0.3):
    - Use for: focusing training on poorly predicted regions
    - Pros: gamma exponents adapt emphasis to prediction quality
    - Cons: complex; four hyperparameters

13. Distance Map BCE — key 'distance_map_bce'
    (config: distance_alpha, default 1.0):
    - Use for: emphasizing object boundaries
    - Pros: per-pixel weights grow near mask edges (EDT-based)
    - Cons: pays for a distance transform per batch (on-device here,
      segtpu_torch/ops/edt.py)

14. Hausdorff Distance — key 'hausdorff' (config: hausdorff_alpha 2.0):
    - Use for: boundary-accuracy-critical tasks
    - Pros: approximates the boundary metric itself
    - Cons: the most expensive loss in the registry

15. Boundary Loss — key 'boundary' (config: boundary_theta0 3,
    boundary_theta 5):
    - Use for: precise boundary segmentation
    - Pros: strongest boundary emphasis
    - Cons: can neglect region interiors; pair with a region loss
"""
