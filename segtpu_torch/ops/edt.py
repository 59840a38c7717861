"""Exact Euclidean distance transform on tensors (port of
``segtpu/ops/edt.py``).

The same two passes as the JAX op, so both give the same distances bit
for bit: per column the distance in rows to the nearest zero (two
cumulative max/min scans, ``torch.cummax``/``torch.cummin`` for
``lax.cummax``/``lax.cummin``), then the exact lower envelope
``min_k g(i,k)² + (j−k)²`` as a dense broadcast reduction. scipy's
``distance_transform_edt`` semantics, including its quirk for an image
with no zero at all (distance to the virtual index (−1, 0)).
"""

from __future__ import annotations

import torch

_BIG = 1e10
# elements of one (rows, W, W) broadcast block of the envelope
_BLOCK = 1 << 24


def _column_dist(nonzero: torch.Tensor) -> torch.Tensor:
    """Per-column distance (in rows) to the nearest zero of ``nonzero``
    (…, H, W) bool; float32, ``_BIG`` where the column has no zero."""
    h = nonzero.shape[-2]
    idx = torch.arange(h, dtype=torch.float32,
                       device=nonzero.device)[:, None]
    big = torch.tensor(_BIG, dtype=torch.float32, device=nonzero.device)
    last_zero = torch.cummax(torch.where(~nonzero, idx, -big), dim=-2).values
    d_down = idx - last_zero                      # to a zero at or above
    next_zero = torch.flip(torch.cummin(torch.flip(
        torch.where(~nonzero, idx, big), (-2,)), dim=-2).values, (-2,))
    d_up = next_zero - idx                        # to a zero at or below
    return torch.clamp(torch.minimum(d_down, d_up), max=_BIG)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (through float64): the
    CPU's vectorised float32 ``torch.sqrt`` is one ulp off at some
    integers (√1421), where XLA's and numpy's are not."""
    return torch.sqrt(x.double()).float()


def distance_transform_edt(img: torch.Tensor) -> torch.Tensor:
    """Exact EDT over the last two dims of ``img`` (…, H, W), any dtype
    (nonzero is foreground): the distance from each nonzero element to
    the nearest zero of its (H, W) slice. Returns float32 (…, H, W)."""
    nonzero = img != 0
    *lead, h, w = img.shape
    g = _column_dist(nonzero).reshape(-1, h, w)
    ks = torch.arange(w, dtype=torch.float32, device=img.device)
    g2 = torch.clamp(g * g, max=_BIG)             # cap: no inf overflow
    dj = (ks[None, :] - ks[:, None]) ** 2         # (Wj, Wk)
    rows = g2.reshape(-1, w)
    step = max(1, _BLOCK // (w * w))
    d2 = torch.cat([torch.amin(r[:, None, :] + dj[None], dim=-1)
                    for r in rows.split(step)]).reshape(g.shape)
    d2 = torch.where(nonzero.reshape(g.shape), d2, 0.0)
    ii = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    corner = _sqrt((ii + 1.0) ** 2 + ks[None, :] ** 2)
    any_zero = (~nonzero.reshape(g.shape)).flatten(1).any(dim=1)
    out = torch.where(any_zero[:, None, None], _sqrt(d2), corner)
    return out.reshape(*lead, h, w)
