"""Configuration conventions (port of ``segtpu/core/config.py``).

The reference uses plain dicts with a ``config.get(key, default)``
convention (train.py:169-170,333-343; losses.py:345-397); the port keeps
the same key names and defaults, and the helpers the drivers use for
merging and grid expansion (loss_function_cross_validation.py:39-57,
model_configuration_experiment.py:41-78).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterable, List

import numpy as np


def cfg_get(config: Dict, key: str, default: Any = None) -> Any:
    """config.get with None-tolerance (reference convention)."""
    if config is None:
        return default
    return config.get(key, default)


def merge_config(base: Dict, **overrides) -> Dict:
    """``{**base_config, ...}`` merge used throughout the reference drivers."""
    out = dict(base)
    out.update(overrides)
    return out


def expand_grid(base: Dict, options: Dict[str, Iterable]) -> List[Dict]:
    """Cartesian-product grid expansion over ``options``
    (reference: model_configuration_experiment.py:41-78). Adds a
    descriptive ``name`` and records the varied params under
    ``config_params``."""
    names = list(options.keys())
    values = [list(v) for v in options.values()]
    configs = []
    for combo in itertools.product(*values):
        cfg = dict(base)
        params = {}
        name_parts = []
        for k, v in zip(names, combo):
            cfg[k] = v
            params[k] = v
            if k == "use_attention":
                name_parts.append(f"att_{v}")
            elif k == "batch_size":
                name_parts.append(f"bs_{v}")
            else:
                name_parts.append(f"{k}_{v}")
        cfg["name"] = "_".join(name_parts)
        cfg["config_params"] = params
        configs.append(cfg)
    return configs


def set_seed(seed: int) -> None:
    """Seed the host-side generators of python and numpy (the reference
    seeds them ad hoc, e.g. augmentation_amount_experiment.py:355-360).
    The port's torch randomness takes explicit ``torch.Generator``s
    seeded from ``config["seed"]``."""
    random.seed(seed)
    np.random.seed(seed)
