"""Optimizers and the epoch-boundary LR/stop controllers (port of
``segtpu/train/optim.py``).

- ``make_optimizer``: ``adam`` is ``torch.optim.Adam`` with its coupled L2
  weight decay (the reference's optimizer, train.py:331-335); ``adamw``
  and ``sgd`` (momentum 0.9, dampening 0, optional Nesterov) are their
  ``torch.optim`` classes; torch has no LAMB, so ``lamb`` is ``Lamb``
  below, which follows optax's chain. These are the update rules the JAX
  package composes from optax (its ``adam``/``adamw``/``sgd`` chains are
  the torch rules). The learning rate of every group is set per epoch by
  ``set_learning_rate``.
- ``functional_init`` / ``functional_step``: the same four update rules
  on tensors with a leading fold axis, one learning rate per fold, for
  the ``vmap`` fold-parallel strategy; ``load_functional_state`` hands
  one fold's moments to a ``torch.optim`` optimizer.
- ``ReduceLROnPlateau`` and ``EarlyStopping``: pure Python, as in the JAX
  package (mode max, relative threshold; patience counter).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class Lamb(torch.optim.Optimizer):
    """LAMB as optax's ``lamb`` composes it: Adam moments with bias
    correction, u = m̂/(√v̂ + eps); u += weight_decay·p; u ·= ‖p‖/‖u‖ per
    tensor (1 where either norm is 0); p −= lr·u."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                g, m, v = p.grad, st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** st["step"])) / (
                    torch.sqrt(v / (1 - b2 ** st["step"])) + group["eps"])
                u.add_(p, alpha=group["weight_decay"])
                p_norm, u_norm = torch.linalg.vector_norm(p), \
                    torch.linalg.vector_norm(u)
                trust = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.sub_(u * trust, alpha=group["lr"])
        return loss


def _adam(params, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def _adamw(params, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, weight_decay, momentum=0.9, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0,
                           nesterov=nesterov, weight_decay=weight_decay)


def _lamb(params, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-6):
    return Lamb(params, lr=lr, betas=(b1, b2), eps=eps,
                weight_decay=weight_decay)


_OPTIMIZERS = {"adam": _adam, "adamw": _adamw, "sgd": _sgd, "lamb": _lamb}


def make_optimizer(name: str, params, learning_rate: float = 1e-3,
                   weight_decay: float = 0.0, **kwargs
                   ) -> torch.optim.Optimizer:
    """Optimizer ``name`` (config key ``optimizer``) over ``params``;
    kwargs: ``b1``, ``b2``, ``eps`` (adam, adamw, lamb), ``momentum``,
    ``nesterov`` (sgd)."""
    try:
        factory = _OPTIMIZERS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown optimizer '{name}'. "
            f"Available: {sorted(_OPTIMIZERS)}") from None
    return factory(params, float(learning_rate), float(weight_decay),
                   **kwargs)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


# ------------------------------------------------- functional, per fold
# State keys per optimizer: "exp_avg"/"exp_avg_sq" (adam, adamw, lamb),
# "momentum_buffer" (sgd with momentum); each {param name: (K, ...)}.

_MOMENTS = {"adam": ("exp_avg", "exp_avg_sq"),
            "adamw": ("exp_avg", "exp_avg_sq"),
            "lamb": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buffer",)}


def functional_init(name: str, params: Dict[str, torch.Tensor]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero moments for stacked ``params`` (the state of a fresh
    optimizer)."""
    if name.lower() not in _MOMENTS:
        raise ValueError(f"Unknown optimizer '{name}'. "
                         f"Available: {sorted(_OPTIMIZERS)}")
    return {key: {n: torch.zeros_like(p) for n, p in params.items()}
            for key in _MOMENTS[name.lower()]}


def _per_fold(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) → broadcastable against ``like`` (K, ...), in its dtype."""
    return v.to(like.dtype).view(-1, *([1] * (like.dim() - 1)))


@torch.no_grad()
def functional_step(name: str, params: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor],
                    state: Dict[str, Dict[str, torch.Tensor]],
                    lrs: torch.Tensor, weight_decay: float, step: int,
                    b1: float = 0.9, b2: float = 0.999, eps=None,
                    momentum: float = 0.9, nesterov: bool = False) -> None:
    """One update of stacked ``params`` in place, fold f at ``lrs[f]``
    (float64), ``step`` the update's 1-based count: the rules of
    ``make_optimizer(name)``, written as torch's single-tensor
    implementations compute them (Adam's moments by ``lerp_`` and
    ``addcmul_``, bias corrections in float64, coupled L2 for adam and
    sgd, decoupled for adamw)."""
    name = name.lower()
    wd = float(weight_decay)
    if name in ("adam", "adamw"):
        eps = 1e-8 if eps is None else eps
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        for n, p in params.items():
            g, m, v = grads[n], state["exp_avg"][n], state["exp_avg_sq"][n]
            if name == "adamw":
                p.mul_(_per_fold(1 - lrs * wd, p))
            elif wd:
                g = g.add(p, alpha=wd)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(eps)
            p.add_(-_per_fold(lrs / bc1, p) * m / denom)
    elif name == "sgd":
        for n, p in params.items():
            g = grads[n].add(p, alpha=wd) if wd else grads[n]
            if momentum:
                buf = state["momentum_buffer"][n]
                if step == 1:
                    buf.copy_(g)
                else:
                    buf.mul_(momentum).add_(g)
                g = g.add(buf, alpha=momentum) if nesterov else buf
            p.add_(-_per_fold(lrs, p) * g)
    elif name == "lamb":
        eps = 1e-6 if eps is None else eps
        for n, p in params.items():
            g, m, v = grads[n], state["exp_avg"][n], state["exp_avg_sq"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / (1 - b1 ** step)) / (
                torch.sqrt(v / (1 - b2 ** step)) + eps)
            u.add_(p, alpha=wd)
            p_norm = torch.linalg.vector_norm(p.flatten(1), dim=1)
            u_norm = torch.linalg.vector_norm(u.flatten(1), dim=1)
            trust = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            p.sub_(u * _per_fold(trust, p) * _per_fold(lrs, p))
    else:
        raise ValueError(f"Unknown optimizer '{name}'. "
                         f"Available: {sorted(_OPTIMIZERS)}")


def load_functional_state(optimizer: torch.optim.Optimizer, name: str,
                          model: torch.nn.Module,
                          state: Dict[str, Dict[str, torch.Tensor]],
                          k: int, step: int) -> None:
    """Fold ``k``'s moments after ``step`` updates into ``optimizer`` (made
    by ``make_optimizer(name)`` over ``model``'s parameters), so that it
    continues that fold's training."""
    if step == 0:
        return
    name = name.lower()
    for n, p in model.named_parameters():
        st = {key: state[key][n][k].clone() for key in state}
        if name in ("adam", "adamw"):
            st["step"] = torch.tensor(float(step))
        elif name == "lamb":
            st["step"] = step
        optimizer.state[p] = st


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau parity (the subset the reference uses:
    mode='max', threshold_mode='rel', cooldown=0)."""

    def __init__(self, initial_lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 3, threshold: float = 1e-4,
                 min_lr: float = 0.0):
        assert mode in ("max", "min")
        self.lr = float(initial_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return current > self.best * (1.0 + self.threshold) if self.best >= 0 \
                else current > self.best * (1.0 - self.threshold)
        return current < self.best * (1.0 - self.threshold) if self.best >= 0 \
            else current < self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def safe_horizon(self) -> int:
        """Epoch-pipelining lookahead bound: how many upcoming epochs are
        GUARANTEED to train at the current LR, whatever their metrics.

        From bad-count b, an LR cut needs the count to exceed ``patience``,
        which takes at least ``patience - b + 1`` more steps even if every
        one is bad — and a cut at step j only affects epoch j+1. So the
        next ``patience - b + 1`` epochs can be dispatched before their
        metrics are fetched with zero mis-speculation (train_model's
        windowed loop, segtpu/train/loop.py). At the LR floor no further
        change is possible at all."""
        if self.lr <= self.min_lr:
            return 1 << 30
        return self.patience - self.num_bad_epochs + 1


class EarlyStopping:
    """Patience counter on a max-mode score (utils.py:174-190)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False

    def step(self, current_score: float) -> bool:
        if self.best_score is None or current_score > self.best_score + self.min_delta:
            self.best_score = current_score
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    def safe_horizon(self) -> int:
        """Epoch-pipelining lookahead bound: how many upcoming epochs may
        be dispatched such that a stop decision can only land on the LAST
        of them (so none of the dispatched epochs is wasted). From counter
        c the stop needs at least ``patience - c`` more bad steps."""
        return max(1, self.patience - self.counter)
