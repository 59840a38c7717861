"""Optimizers and the epoch-boundary LR/stop controllers (port of
``segtpu/train/optim.py``).

- ``make_optimizer``: a ``DeviceOptimizer`` of one of four update rules,
  the ones the JAX package composes from optax: ``adam`` with its coupled
  L2 weight decay (the reference's optimizer, train.py:331-335),
  ``adamw`` with decoupled decay, ``sgd`` (momentum 0.9, dampening 0,
  optional Nesterov) and ``lamb`` (optax's chain), with the LR and the
  step counts on the device, so that the stepwise loop and the fused
  run's CUDA graphs step the same optimizer. The learning rate is set
  per epoch by ``set_learning_rate``.
- ``functional_init`` / ``functional_step``: the same four update rules
  on tensors with a leading fold axis, one learning rate per fold, for
  the ``vmap`` fold-parallel strategy; ``load_functional_state`` hands
  one fold's moments to a ``make_optimizer`` optimizer.
- ``ReduceLROnPlateau`` and ``EarlyStopping``: pure Python, as in the JAX
  package (mode max, relative threshold; patience counter).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# moments per rule (state keys, as torch's optimizers name them)
_MOMENTS = {"adam": ("exp_avg", "exp_avg_sq"),
            "adamw": ("exp_avg", "exp_avg_sq"),
            "lamb": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buffer",)}
# hyperparameters per rule and their defaults
_HYPER = {"adam": dict(b1=0.9, b2=0.999, eps=1e-8),
          "adamw": dict(b1=0.9, b2=0.999, eps=1e-8),
          "lamb": dict(b1=0.9, b2=0.999, eps=1e-6),
          "sgd": dict(momentum=0.9, nesterov=False)}


def _unknown(name: str) -> ValueError:
    return ValueError(f"Unknown optimizer '{name}'. "
                      f"Available: {sorted(_HYPER)}")


class DeviceOptimizer(torch.optim.Optimizer):
    """Update rule ``rule`` (adam, adamw, sgd, lamb) over one group of
    parameters, with the learning rate (``param_groups[0]["lr"]``, 0-d
    float64) and the step counts (``state[p]["step"]``, 0-d float32) held
    as tensors on the parameters' device. ``step()`` reads both there,
    reads nothing back to the host and branches on no device value (SGD's
    first step, which takes the gradient as its momentum, is a ``where``
    on the step count), so a CUDA graph that captured it replays it at the
    LR and the bias correction of the moment. The stepwise loop calls
    ``step()`` eagerly and the fused run (``train/fused_run.py``) replays
    it, so the two run the same kernels on the same values.

    The arithmetic (``_update``) is that of torch's ``Adam``, ``AdamW``
    and ``SGD`` and of the port's earlier per-tensor LAMB (optax's chain)
    as torch runs them on each device, with the Python scalars they
    derive from the LR and the step count held as 0-d tensors: the
    stepwise loop keeps the numbers it had with those optimizers, on the
    CPU and on the card. The state is made with the optimizer, zero,
    so that the first step can be captured too; every parameter must have
    a gradient at every step (the step counts stay equal), as every
    parameter of the port's models does."""

    def __init__(self, rule: str, params, lr: float = 1e-3,
                 weight_decay: float = 0.0, **hyper):
        rule = rule.lower()
        if rule not in _HYPER:
            raise _unknown(rule)
        unknown = set(hyper) - set(_HYPER[rule])
        if unknown:
            raise TypeError(f"{rule}: unknown hyperparameters "
                            f"{sorted(unknown)}")
        h = {**_HYPER[rule], **hyper}
        if rule == "sgd":
            defaults = dict(lr=lr, weight_decay=float(weight_decay),
                            momentum=float(h["momentum"]),
                            nesterov=bool(h["nesterov"]))
        else:
            defaults = dict(lr=lr, weight_decay=float(weight_decay),
                            betas=(float(h["b1"]), float(h["b2"])),
                            eps=float(h["eps"]))
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("DeviceOptimizer: one parameter group")
        self.rule = rule
        (group,) = self.param_groups
        dev = group["params"][0].device
        # a fill, not a copy from the host (which would synchronise)
        group["lr"] = torch.full((), float(lr), dtype=torch.float64,
                                 device=dev)
        self._fill_state()

    @property
    def lr(self) -> torch.Tensor:
        """The learning rate, a 0-d float64 tensor on the device."""
        return self.param_groups[0]["lr"]

    def _hyper(self) -> dict:
        """The rule's hyperparameters, as ``make_optimizer`` takes them."""
        (g,) = self.param_groups
        if self.rule == "sgd":
            return dict(momentum=g["momentum"], nesterov=g["nesterov"])
        return dict(b1=g["betas"][0], b2=g["betas"][1], eps=g["eps"])

    def like(self, params) -> "DeviceOptimizer":
        """A new optimizer of this rule and hyperparameters over
        ``params`` (zero state, LR 0)."""
        return DeviceOptimizer(self.rule, params, 0.0,
                               self.param_groups[0]["weight_decay"],
                               **self._hyper())

    def _fill_state(self) -> None:
        """Zero moments and step counts on the parameters' device where a
        parameter has none (a new optimizer; a loaded state of a step
        before any update); loaded step counts moved there."""
        (g,) = self.param_groups
        keys = _moment_keys(self.rule, g)
        for p in g["params"]:
            st = self.state[p]
            for k in keys:
                if st.get(k) is None:
                    st[k] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            step = st.get("step")
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device) if step is None else \
                torch.as_tensor(step).to(device=p.device,
                                         dtype=torch.float32)

    def load_state_dict(self, state_dict) -> None:
        """torch's load, with the LR and the step counts put back on the
        device as tensors (the LR into the tensor it had)."""
        lr = self.lr
        super().load_state_dict(state_dict)
        with torch.no_grad():
            lr.copy_(torch.as_tensor(self.param_groups[0]["lr"]))
        self.param_groups[0]["lr"] = lr
        self._fill_state()

    @torch.no_grad()
    def copy_from(self, other: "DeviceOptimizer") -> None:
        """``other``'s LR, step counts and moments into this optimizer's
        tensors, in place (so a graph that captured ``step()`` reads them);
        ``other`` has the same rule, its parameters pair with these in
        order."""
        self.lr.copy_(other.lr)
        for p, q in zip(self.param_groups[0]["params"],
                        other.param_groups[0]["params"]):
            for k, t in self.state[p].items():
                t.copy_(other.state[q][k])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        (group,) = self.param_groups
        ps = group["params"]
        if any(p.grad is None for p in ps):
            raise RuntimeError("DeviceOptimizer: every parameter must have "
                               "a gradient at every step")
        steps = [self.state[p]["step"] for p in ps]
        torch._foreach_add_(steps, 1.0)
        hyper = self._hyper()
        _update(self.rule, ps, [p.grad for p in ps],
                {k: [self.state[p][k] for p in ps]
                 for k in _moment_keys(self.rule, hyper)},
                group["lr"], steps[0].double(), group["weight_decay"],
                **hyper)
        return loss


# ------------------------------------------------------------ the rules
# The LR and the step count are float64 tensors on the parameters' device;
# the scalars that torch's rules compute from them in Python (bias
# corrections, step size, 1 − lr·wd) are computed there in float64 and
# cast to the parameters' dtype where torch's ops cast a Python scalar.
# Two ops treat a Python scalar apart on each device, and take that
# device's form here (``_addcdiv_``, ``_div_scalar``): so the stepwise
# loop's numbers are those it had with torch's optimizers, on the CPU
# (single-tensor rules) and on CUDA (foreach rules, torch's default
# there); ``tests/test_torch_fused_run.py`` and ``tests/test_torch_cuda.py``
# hold them to those optimizers bit for bit.

def _moment_keys(rule: str, hyper) -> tuple:
    return () if rule == "sgd" and not hyper["momentum"] else _MOMENTS[rule]


def _addcdiv_(ps, ts1, ts2, value) -> None:
    """``p.addcdiv_(t1, t2, value=v)`` for each p, as torch computes it
    for a Python ``v``; ``value`` a 0-d tensor holding v in the tensors'
    dtype. The CPU's single-tensor rule gives p + (v·t1)/t2; CUDA's
    foreach kernel p + v·(t1/t2) with the product and the sum rounded
    once, as ``addcmul_`` rounds them."""
    if ps[0].device.type == "cpu":
        upd = torch._foreach_mul(ts1, value)
        torch._foreach_div_(upd, ts2)
        torch._foreach_add_(ps, upd)
    else:
        for p, q in zip(ps, torch._foreach_div(ts1, ts2)):
            p.addcmul_(q, value)


def _div_scalar(x, s):
    """``x / v`` as torch computes it for a Python float v, ``s`` a 0-d
    float64 tensor holding v: a true division on the CPU; on CUDA, whose
    kernel takes a host scalar's reciprocal, a product with 1/v (taken in
    float64) in x's dtype."""
    return x / s if x.device.type == "cpu" else x * (1 / s).to(x.dtype)


def _update(rule: str, ps, gs, state, lr, step, weight_decay: float, *,
            b1=0.9, b2=0.999, eps=1e-8, momentum=0.9,
            nesterov=False) -> None:
    """One update of ``ps`` in place by rule ``rule``: gradients ``gs``,
    moments ``state`` ({key: list}), ``lr`` and ``step`` (the update's
    1-based count) 0-d float64 on the device. Reads nothing back to the
    host and branches on no device value."""
    wd, dt = float(weight_decay), ps[0].dtype
    if rule in ("adam", "adamw"):
        ms, vs = state["exp_avg"], state["exp_avg_sq"]
        bc1, bc2 = 1 - torch.pow(b1, step), 1 - torch.pow(b2, step)
        neg_step_size = (-(lr / bc1)).to(dt)
        bc2_sqrt = torch.pow(bc2, torch.full_like(bc2, 0.5)).to(dt)
        if wd and rule == "adamw":
            torch._foreach_mul_(ps, (1 - lr * wd).to(dt))
        elif wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        torch._foreach_lerp_(ms, gs, 1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, eps)
        _addcdiv_(ps, ms, denom, neg_step_size)
    elif rule == "sgd":
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        if momentum:
            bufs, first = state["momentum_buffer"], step == 1
            nxt = torch._foreach_mul(bufs, momentum)
            torch._foreach_add_(nxt, gs)
            for buf, n, g in zip(bufs, nxt, gs):
                buf.copy_(torch.where(first, g, n))
            gs = torch._foreach_add(gs, bufs, alpha=momentum) if nesterov \
                else bufs
        # p.add_(g, alpha=-lr), rounded as add_ rounds it
        neg_lr = (-lr).to(dt)
        for p, g in zip(ps, gs):
            p.addcmul_(g, neg_lr)
    elif rule == "lamb":
        bc1, bc2 = 1 - torch.pow(b1, step), 1 - torch.pow(b2, step)
        neg_lr = (-lr).to(dt)
        for p, g, m, v in zip(ps, gs, state["exp_avg"], state["exp_avg_sq"]):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = _div_scalar(m, bc1) / (torch.sqrt(_div_scalar(v, bc2)) + eps)
            u.add_(p, alpha=wd)
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            p.addcmul_(u * trust, neg_lr)
    else:
        raise _unknown(rule)


def make_optimizer(name: str, params, learning_rate: float = 1e-3,
                   weight_decay: float = 0.0, **kwargs) -> DeviceOptimizer:
    """Optimizer ``name`` (config key ``optimizer``) over ``params``;
    kwargs: ``b1``, ``b2``, ``eps`` (adam, adamw, lamb), ``momentum``,
    ``nesterov`` (sgd)."""
    return DeviceOptimizer(name, params, float(learning_rate),
                           float(weight_decay), **kwargs)


def set_learning_rate(optimizer: DeviceOptimizer, lr: float):
    """Set the learning rate (written into its tensor on the device)."""
    with torch.no_grad():
        optimizer.lr.fill_(float(lr))
    return optimizer


# ------------------------------------------------- functional, per fold
# State keys per optimizer: those of ``_MOMENTS``, each {param name:
# (K, ...)}.


def functional_init(name: str, params: Dict[str, torch.Tensor]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero moments for stacked ``params`` (the state of a fresh
    optimizer)."""
    if name.lower() not in _MOMENTS:
        raise _unknown(name)
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
        raise _unknown(name)


def load_functional_state(optimizer: DeviceOptimizer,
                          model: torch.nn.Module,
                          state: Dict[str, Dict[str, torch.Tensor]],
                          k: int, step: int) -> None:
    """Fold ``k``'s moments after ``step`` updates into ``optimizer`` (made
    by ``make_optimizer`` of the same rule over ``model``'s parameters),
    so that it continues that fold's training."""
    if step == 0:
        return
    with torch.no_grad():
        for n, p in model.named_parameters():
            st = optimizer.state[p]
            for key in state:
                st[key].copy_(state[key][n][k])
            st["step"].fill_(float(step))


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
