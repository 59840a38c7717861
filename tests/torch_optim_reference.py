"""The optimizers the port's stepwise loop ran before its learning rate
and step counts moved to the device: torch's ``Adam``, ``AdamW`` and
``SGD`` at their defaults (single-tensor rules on the CPU, foreach rules
on CUDA) and a per-tensor LAMB (optax's chain with Python scalars). The
tests hold ``segtpu_torch.train.optim.DeviceOptimizer`` to them bit for
bit; no JAX here, so the card's tests import it too."""

import torch


class Lamb(torch.optim.Optimizer):
    """Moments with bias correction, u = m̂/(√v̂ + eps) + wd·p,
    u ·= ‖p‖/‖u‖ (1 where either norm is 0), p −= lr·u."""

    def __init__(self, params, lr, weight_decay, b1=0.9, b2=0.999,
                 eps=1e-6):
        super().__init__(params, dict(lr=lr, betas=(b1, b2), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(step=0, exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
                g, m, v = p.grad, st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** st["step"])) / (
                    torch.sqrt(v / (1 - b2 ** st["step"])) + group["eps"])
                u.add_(p, alpha=group["weight_decay"])
                pn, un = (torch.linalg.vector_norm(t) for t in (p, u))
                trust = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                p.sub_(u * trust, alpha=group["lr"])


def reference_optimizer(name, params, lr, weight_decay, **kw):
    """The reference that ``make_optimizer(name, ...)`` follows."""
    if name == "lamb":
        return Lamb(params, lr, weight_decay, **kw)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=weight_decay, **kw)
    cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
    return cls(params, lr=lr, weight_decay=weight_decay, **kw)


def set_reference_lr(optimizer, lr) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
