"""Checkpoints of a training state (port of ``segtpu/train/checkpoint.py``).

One ``torch.save`` file ``path/name.pt`` holding the model's
``state_dict`` under the reference's key names, the optimizer's state and
the plateau scheduler's state; read back with
``torch.load(weights_only=True)``, so loading runs no pickled code.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(path: str, state, name: str = "checkpoint",
                    scheduler=None) -> str:
    """Save ``state`` (a ``TrainState``) and, if given, the
    ``ReduceLROnPlateau`` ``scheduler`` under ``path/name.pt``. Returns
    the file's path."""
    os.makedirs(path, exist_ok=True)
    target = os.path.abspath(os.path.join(path, f"{name}.pt"))
    blob: Dict = {"model": {k: v.detach().cpu() for k, v in
                            state.model.state_dict().items()}}
    if state.optimizer is not None:
        blob["optimizer"] = state.optimizer.state_dict()
    if scheduler is not None:
        blob["scheduler"] = dict(vars(scheduler))
    torch.save(blob, target)
    print("Saving checkpoint:", target)
    return target


def load_checkpoint(path: str, name: str = "checkpoint",
                    state=None, scheduler=None) -> Dict:
    """The dict ``save_checkpoint`` wrote (tensors on the CPU). With
    ``state`` and ``scheduler`` given, their model, optimizer and
    scheduler are restored from it in place."""
    full = os.path.abspath(os.path.join(path, f"{name}.pt"))
    blob = torch.load(full, map_location="cpu", weights_only=True)
    if state is not None:
        state.model.load_state_dict(blob["model"], strict=True)
        if state.optimizer is not None and "optimizer" in blob:
            state.optimizer.load_state_dict(blob["optimizer"])
    if scheduler is not None and "scheduler" in blob:
        vars(scheduler).update(blob["scheduler"])
    return blob
