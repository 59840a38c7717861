"""What the reference computes for a comparison: the logits of a batch of
images, and the training steps of one epoch followed step by step.

Everything runs in float32 with TF32 off (``exact_f32``), on whatever
device the caller's tensors are on, in plain PyTorch: ``torch.optim.Adam``
with its coupled L2 weight decay is the reference's optimizer
(``train.py:331-335``), the combo loss the reference's default.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from portbench.reference.unet import UNet, combo_loss


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32, restored on
    exit."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def build(model_cfg: Dict, state_dict: Dict[str, torch.Tensor],
          device) -> UNet:
    """The reference U-Net of ``model_cfg`` holding ``state_dict``."""
    model = UNet(model_cfg["backbone"], model_cfg["use_attention"],
                 model_cfg["n_classes"]).to(device)
    model.load_state_dict(state_dict, strict=True)
    return model


@torch.no_grad()
def logits(model: UNet, images: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """Logits (N, 1, H, W) float32 of images (N, 1, H, W), eval mode,
    ``chunk`` images at a time."""
    model.eval()
    with exact_f32():
        return torch.cat([model(images[i:i + chunk])
                          for i in range(0, images.shape[0], chunk)])


def grad_norm(state: Dict) -> float:
    """√Σv of one parameter's Adam state (0 where it has none): the second
    moment's sum is (1−β₂)·Σᵢ β₂^(n−i)·‖gᵢ‖², so its root is the steps'
    gradient norm as the optimizer got them."""
    if "exp_avg_sq" not in state:
        return 0.0
    return state["exp_avg_sq"].sum().sqrt().item()


def follow_epoch(model: UNet, train_x, train_y, perm, batch_size: int,
                 lr: float, weight_decay: float,
                 fault: Optional[str] = None) -> Dict:
    """The training steps of one epoch as the fused run's first epoch runs
    them: the batches ``train_x[perm]`` in order, each a train-mode
    forward, the combo loss, backward and one Adam step. Returns the
    epoch's sample-weighted train loss (of the pre-update logits), the
    BatchNorms' running statistics it ends with (``stats``, by name) and
    per parameter (by name) the norm of the first step's gradient
    (``grad0``), ``grad_norm`` of Adam's state after the epoch, Adam's
    first moment itself and the norm of the parameter's change.

    ``fault`` plants one of the check's faults in this run (to read what
    the check's numbers do when the program has it): ``"unchanged"``, a
    step that leaves the weights and the optimizer as they were;
    ``"half_batch"``, each step on the first half of its batch only
    (``val_loss`` plants ``"altered"``)."""
    model.train()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           weight_decay=weight_decay)
    names = [n for n, _ in model.named_parameters()]
    b = int(batch_size)
    n_full = train_x.shape[0] // b
    train_loss = 0.0
    grad0 = None
    with exact_f32():
        for i in range(n_full):
            idx = perm[i * b:(i + 1) * b]
            x, y = train_x[idx], train_y[idx]
            if fault == "half_batch":
                x, y = x[:b // 2], y[:b // 2]
            opt.zero_grad(set_to_none=True)
            loss = combo_loss(model(x), y)
            loss.backward()
            if grad0 is None:
                grad0 = {n: p.grad.detach().norm().item()
                         for n, p in model.named_parameters()}
            if fault != "unchanged":
                opt.step()
            train_loss += loss.item() * b
    params = dict(model.named_parameters())
    state = {n: opt.state.get(params[n], {}) for n in names}
    return {
        "train_loss": train_loss / (n_full * b),
        "grad0": grad0,
        "grad": {n: grad_norm(state[n]) for n in names},
        "moment": {n: state[n]["exp_avg"] if "exp_avg" in state[n]
                   else torch.zeros_like(params[n]) for n in names},
        "change": {n: (params[n].detach() - start[n]).norm().item()
                   for n in names},
        "stats": {n: t.detach().clone() for n, t in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))},
    }


@torch.no_grad()
def val_loss(model: UNet, images, masks, batch_size: int,
             fault: Optional[str] = None) -> float:
    """The validation loss as the fused run's validation pass takes it:
    eval mode (the running statistics), the combo loss of each batch of
    ``batch_size`` images in order, weighted by its images. ``fault``
    ``"altered"`` negates the first image's logits where they are
    produced (an answer altered: that image's map inverted)."""
    model.eval()
    total, n = 0.0, images.shape[0]
    with exact_f32():
        for i in range(0, n, batch_size):
            out = model(images[i:i + batch_size])
            if fault == "altered" and i == 0:
                out = torch.cat([-out[:1], out[1:]])
            total += combo_loss(out, masks[i:i + batch_size]).item() \
                * out.shape[0]
    return total / n
