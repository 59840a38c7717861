"""Shared experiment utilities: JSON-safe result persistence and figures
(port of ``segtpu/experiments/common.py``).

Results persist as JSON (robust, inspectable, resumable), with numpy
scalars and arrays and torch tensors turned into numbers."""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Callable

import numpy as np
import torch


def to_jsonable(obj: Any):
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def save_results(save_dir: str, name: str, results: Any) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    with open(path, "w") as f:
        json.dump(to_jsonable(results), f, indent=2)
    print(f"Results saved to {path}")
    return path


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S")


def draw_figure(plot: Callable, *args, **kwargs) -> None:
    """``plot(*args, **kwargs)`` where matplotlib can be imported; else
    one line saying the figure was not drawn (the card's machine has no
    matplotlib; every JSON artefact is written all the same)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("figure not drawn: matplotlib is not installed")
        return
    plot(*args, **kwargs)
